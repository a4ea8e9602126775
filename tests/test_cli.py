"""End-to-end CLI smoke tests (L5).

Exercises the real user entry point — ``python -m parasitoids_tpu`` in a
fresh interpreter — on a tiny config, and checks the reference-format
outputs round-trip (ref Run.py:523-531 driver + Run.py:490-516 save path).
"""

import json
import os
import subprocess

import pytest
import sys

import numpy as np

from parasitoids_tpu.io.save import load_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ['--no_plot', 'ndays=3', 'domain_info=(2000.0,50)', 'interp_num=4',
        'kernel_rad=12', 'kernel_rad_local=5', 'quad_nodes=8']


def _run_cli(args, outfile):
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    r = subprocess.run(
        [sys.executable, '-m', 'parasitoids_tpu'] + args +
        ['outfile=' + outfile],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=560)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_cli_prob_model_end_to_end(tmp_path):
    out = str(tmp_path / 'prob_run')
    stdout = _run_cli(['--kalbar'] + TINY, out)
    assert 'probability model' in stdout
    assert 'Kernel phase' in stdout and 'Convolution phase' in stdout

    # reference-format outputs: npz of CSR triplets + json params sidecar
    fields, days = load_run(out, 101)
    assert len(days) == 3
    dense = np.stack([np.asarray(f.todense() if hasattr(f, 'todense')
                                 else f) for f in fields])
    # each day is a pmf
    np.testing.assert_allclose(dense.sum(axis=(1, 2)), 1.0, rtol=1e-4)

    with open(out + '.json') as f:
        saved = json.load(f)
    assert saved['ndays'] == 3
    assert 'maps_key' not in saved     # stripped, ref Run.py:512-516


def test_cli_pop_model_end_to_end(tmp_path):
    out = str(tmp_path / 'pop_run')
    stdout = _run_cli(['--kalbar', '--pop'] + TINY, out)
    assert 'population model' in stdout

    fields, days = load_run(out, 101)
    dense = np.stack([np.asarray(f.todense() if hasattr(f, 'todense')
                                 else f) for f in fields])
    # population conservation: totals within 1% of released wasps
    # (ref test_Result.py:12-25), modulo boundary loss on a tiny domain
    from parasitoids_tpu.config import Params
    p = Params()
    p.cmd_line_chg(['--kalbar'])
    totals = dense.sum(axis=(1, 2))
    assert np.all(totals <= p.r_number * 1.01)
    assert totals[0] > 0.5 * p.r_number


def test_analyze_menu(tmp_path, monkeypatch, capsys):
    """--analyze drives the reference-style post-sampling menu
    (Bayes_Run.py:540-702) from a saved store, no forward model needed."""
    from parasitoids_tpu.bayes.priors import (MODEL_PARAM_NAMES,
                                              OBS_PARAM_NAMES)
    from parasitoids_tpu.bayes import run as bayes_run

    n_sent = 4
    dim = len(MODEL_PARAM_NAMES) + len(OBS_PARAM_NAMES) + n_sent + 1
    rng = np.random.default_rng(0)
    db = str(tmp_path / 'an_store')
    np.savez(db, traces=rng.normal(size=(2, 50, dim)))
    with open(db + '.meta.json', 'w') as fh:
        json.dump({'sampler': 'am'}, fh)

    answers = iter(['s', 'r', 'x', 'q'])
    monkeypatch.setattr('builtins.input', lambda *_: next(answers))
    monkeypatch.chdir(tmp_path)          # diagnostics/ lands in tmp
    bayes_run.main(['--analyze', db])
    out = capsys.readouterr().out
    assert '2 chain(s) x 50 samples' in out
    assert 'posterior means' in out
    assert 'Gelman-Rubin' in out
    assert '--resume' in out
    assert 'unrecognized option' in out
    assert (tmp_path / 'diagnostics' / 'gelman-rubin.txt').exists()


def test_analyze_menu_trace_window_and_gr_export(tmp_path, monkeypatch,
                                                 capsys):
    """The [t] action plots a trace window for selected variables and the
    [g] action exports gelman-rubin.txt (the remaining breadth of the
    reference menus: Bayes_Run.py:540-702 trace windows, per-variable
    selection, gelman-rubin.txt)."""
    from parasitoids_tpu.bayes import run as bayes_run
    from parasitoids_tpu.bayes.priors import (MODEL_PARAM_NAMES,
                                              OBS_PARAM_NAMES)

    n_sent = 4
    dim = len(MODEL_PARAM_NAMES) + len(OBS_PARAM_NAMES) + n_sent + 1
    rng = np.random.default_rng(1)
    db = str(tmp_path / 'an2_store')
    np.savez(db, traces=rng.normal(size=(2, 60, dim)))

    answers = iter(['t', 'sig_x g_aw', '10 50',     # windowed selection
                    't', 'not_a_param', '',          # bad name -> error msg
                    'g', 'q'])
    monkeypatch.setattr('builtins.input', lambda *_: next(answers))
    monkeypatch.chdir(tmp_path)
    bayes_run.main(['--analyze', db])
    out = capsys.readouterr().out
    assert 'wrote 2 plot(s)' in out
    assert (tmp_path / 'diagnostics' / 'trace_sig_x.png').exists()
    assert (tmp_path / 'diagnostics' / 'trace_g_aw.png').exists()
    assert not (tmp_path / 'diagnostics' / 'trace_lam.png').exists()
    assert 'unknown parameter name' in out
    assert (tmp_path / 'diagnostics' / 'gelman-rubin.txt').exists()
    gr = (tmp_path / 'diagnostics' / 'gelman-rubin.txt').read_text()
    assert 'sig_x' in gr


def test_plot_result_menu(tmp_path, monkeypatch, capsys):
    """The interactive loader (ref Plot_Result.py:491-595): prompts for
    day numbers until quit."""
    import shutil

    from parasitoids_tpu.viz import plot_result

    src = os.path.join('tests', 'golden', 'kalbar_prob_tiny')
    run = str(tmp_path / 'menurun')
    shutil.copy(src + '.npz', run + '.npz')
    shutil.copy(src + '.json', run + '.json')

    answers = iter(['not-a-day', '13', 'q'])
    monkeypatch.setattr('builtins.input', lambda *_: next(answers))
    plot_result.main([run, 'menu'])
    out = capsys.readouterr().out
    assert 'days in this run' in out
    assert 'unrecognized input' in out
    assert os.path.exists(run + '_day13.png')


@pytest.mark.slow
def test_summary_report(tmp_path, monkeypatch):
    """bayes.summary builds the one-command markdown report end to end."""
    import jax.numpy as jnp

    from parasitoids_tpu.bayes.model import BayesSetup
    from parasitoids_tpu.bayes.priors import (initial_model_params,
                                              initial_obs_params)
    from parasitoids_tpu.bayes.summary import build_report
    from parasitoids_tpu.config import Params

    p = Params()
    p.cmd_line_chg(['--kalbar'])
    p.PLOT = False
    p.OUTPUT = False
    p.PROB_MODEL = False
    p.ndays = 3
    p.domain_info = (10000.0, 50)
    p.interp_num = 2
    p.kernel_rad = 6
    p.kernel_rad_local = 3
    p.quad_nodes = 8
    setup = BayesSetup(p)

    m0 = np.asarray(initial_model_params(), np.float32)
    o0 = np.asarray(initial_obs_params(
        [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
        setup.cell_res ** 2), np.float32)
    rng = np.random.default_rng(0)
    rows = [np.concatenate([
        m0 * (1 + 0.01 * rng.normal(size=m0.shape)).astype(np.float32),
        o0, [0.0]]) for _ in range(8)]
    traces = np.stack(rows)[None].astype(np.float64)

    base = str(tmp_path / 'rep_trace')
    np.savez(base, traces=traces)
    monkeypatch.chdir(tmp_path)      # ./diagnostics lands in tmp
    out = build_report(setup, traces, base + '.npz', draws=4, group='block')
    text = open(out).read()
    for section in ('## Posterior', '## Convergence',
                    '## Posterior-predictive p-values',
                    '## Predictive assessment',
                    '## Prior/likelihood sensitivity'):
        assert section in text, section
    assert os.path.exists(base + '_predictive.png')
    assert os.path.exists(base + '_loo.png')
    assert os.path.exists(base + '_sensitivity.png')
    assert os.path.exists(base + '_spread.npz')
    assert os.path.exists(base + '_spread_d{}.png'.format(setup.ndays))
    assert 'posterior spread map' in text
    assert (tmp_path / 'diagnostics').exists()

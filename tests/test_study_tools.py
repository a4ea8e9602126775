"""Unattended-study tooling tests (VERDICT r2 item 5).

The round-2 chain runner half-landed three evidence items because its
support tools were fragile: ``summarize_sbc_ckpt.py`` crashed with
FileNotFoundError when a COMPLETED arm had (correctly) deleted its
checkpoint, and phase retries restarted from zero.  These tests pin the
repaired behavior: every (checkpoint, final-ranks) state maps to either a
recorded artifact or a loud, correct exit code — never an unhandled
traceback.  Resilience role of the reference's try/except -> db.close
blocks (Bayes_Run.py:500-503).
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, 'scripts', 'summarize_sbc_ckpt.py')


def _run(*argv):
    return subprocess.run([sys.executable, SCRIPT, *argv],
                          capture_output=True, text=True)


def _write_ckpt(path, done=12, dim=4, L=20, seed=0):
    rng = np.random.default_rng(seed)
    ranks = np.zeros((50, dim), np.int64)
    ranks[:done] = rng.integers(0, L + 1, (done, dim))
    np.savez(path, ranks=ranks, truths=np.zeros((50, dim)), done=done,
             L=L, seed=seed, sampler='am', warm=0,
             names=np.asarray(['p{}'.format(j) for j in range(dim)]))


def test_summarizer_writes_partial_block(tmp_path):
    ckpt = tmp_path / 'sbc_am.ckpt.npz'
    _write_ckpt(str(ckpt))
    r = _run(str(ckpt), 'am', str(tmp_path))
    assert r.returncode == 0, r.stderr
    with open(tmp_path / 'summary.json') as f:
        block = json.load(f)['samplers']['am']
    assert block['partial'] is True
    assert block['replicates'] == 12
    assert set(block['chi2_pvals']) == {'p0', 'p1', 'p2', 'p3'}


def test_summarizer_completed_and_cleaned_arm_is_success(tmp_path):
    """A completed arm deletes its checkpoint AFTER writing the final ranks
    npz — the summarizer must treat that as success (the exact state that
    once crashed a study run with a FileNotFoundError)."""
    np.savez(tmp_path / 'sbc_am_ranks.npz', ranks=np.zeros((100, 4)),
             L=20, truths=np.zeros((100, 4)),
             names=np.asarray(['a', 'b', 'c', 'd']))
    r = _run(str(tmp_path / 'sbc_am.ckpt.npz'), 'am', str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert 'arm complete' in r.stdout


def test_summarizer_never_started_arm_fails_loudly(tmp_path):
    r = _run(str(tmp_path / 'sbc_am.ckpt.npz'), 'am', str(tmp_path))
    assert r.returncode == 1
    assert 'never started' in r.stdout


def test_summarizer_falls_back_to_durable_twin(tmp_path):
    """A VM recycle deletes the gitignored transient ckpt; the committed
    durable twin (bayes/sbc.py) must still yield a partial summary."""
    _write_ckpt(str(tmp_path / 'sbc_am_partial.npz'), done=7)
    r = _run(str(tmp_path / 'sbc_am.ckpt.npz'), 'am', str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert 'durable twin' in r.stdout
    with open(tmp_path / 'summary.json') as f:
        block = json.load(f)['samplers']['am']
    assert block['partial'] is True
    assert block['replicates'] == 7


def test_summarizer_keeps_complete_block(tmp_path):
    """A partial summary must never clobber a COMPLETE block already
    recorded by run_sbc_study (e.g. a stale checkpoint from an older
    config lying around after the arm finished)."""
    with open(tmp_path / 'summary.json', 'w') as f:
        json.dump({'samplers': {'am': {'partial': False,
                                       'replicates': 100}}}, f)
    ckpt = tmp_path / 'sbc_am.ckpt.npz'
    _write_ckpt(str(ckpt), done=5)
    r = _run(str(ckpt), 'am', str(tmp_path))
    assert r.returncode == 0, r.stderr
    with open(tmp_path / 'summary.json') as f:
        block = json.load(f)['samplers']['am']
    assert block['replicates'] == 100      # untouched


# ----------------------------------------------------------------------
# analyze_sbc_ranks.py — the artifact-vs-defect discriminator must
# actually discriminate (synthetic ranks with known structure)
# ----------------------------------------------------------------------

def _analyze(ranks, L, names):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'analyze_sbc_ranks', os.path.join(REPO, 'scripts',
                                          'analyze_sbc_ranks.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.analyze(ranks, L, names)


def test_rank_analysis_flags_directional_defect():
    """A biased parameter (ranks piled low across replicates,
    independently) must show a large mean-shift |z| WITHOUT a large
    co-occurrence variance ratio."""
    rng = np.random.default_rng(0)
    R, dim, L = 200, 10, 80
    ranks = rng.integers(0, L + 1, (R, dim))
    ranks[:, 3] = rng.integers(0, L // 3, R)        # defect: skewed low
    names = ['p{}'.format(j) for j in range(dim)]
    res = _analyze(ranks, L, names)
    assert abs(res['mean_rank_shift_z']['p3']) > 6
    assert all(abs(res['mean_rank_shift_z'][n]) < 4
               for n in names if n != 'p3')
    assert res['co_occurrence_var_ratio'] < 2.5


def test_rank_analysis_flags_replicate_clustering():
    """Slow-mixing replicates (whole parameter block pinned at extremes
    simultaneously, direction random per replicate) must show a large
    co-occurrence variance ratio with NO directional mean shift."""
    rng = np.random.default_rng(1)
    R, dim, L = 200, 10, 80
    ranks = rng.integers(int(L * 0.15), int(L * 0.85) + 1, (R, dim))
    stuck = rng.random(R) < 0.2                     # 20% slow replicates
    for r in np.where(stuck)[0]:
        side = rng.random() < 0.5                   # random direction
        ranks[r, :] = (rng.integers(0, 3, dim) if side
                       else rng.integers(L - 2, L + 1, dim))
    names = ['p{}'.format(j) for j in range(dim)]
    res = _analyze(ranks, L, names)
    assert res['co_occurrence_var_ratio'] > 4
    assert res['max_abs_shift_z'] < 4


def test_rank_analysis_uniform_is_quiet():
    rng = np.random.default_rng(2)
    R, dim, L = 200, 10, 80
    ranks = rng.integers(0, L + 1, (R, dim))
    res = _analyze(ranks, L, ['p{}'.format(j) for j in range(dim)])
    assert res['co_occurrence_var_ratio'] < 2.0
    assert res['max_abs_shift_z'] < 4
    assert all(v == 'uniform-ish' for v in res['shape'].values())


# ---------------------------------------------------------------------------
# analyze_nuts_run.sampling_wall_s: resumed logs restart the elapsed timer


def _load_analyze_nuts():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'analyze_nuts_run', os.path.join(REPO, 'scripts',
                                         'analyze_nuts_run.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_wall_time_single_segment(tmp_path):
    log = tmp_path / 'run.log'
    log.write_text('NUTS: 2 chains, 10 warmup + 100 samples, max depth 7...\n'
                   '  sample 25/100 (50.0 s)\n'
                   '  sample 50/100 (100.0 s)\n'
                   '  sample 75/100 (150.0 s)\n')
    mod = _load_analyze_nuts()
    assert mod.sampling_wall_s(str(log), 100) == 200.0


def test_wall_time_resumed_log_is_positive(tmp_path):
    # Regression: the flagship pair-A log (3 resume segments, elapsed
    # restarting each time) made the old global linear fit NEGATIVE.
    log = tmp_path / 'run.log'
    log.write_text('NUTS: 2 chains, 10 warmup + 100 samples, max depth 7...\n'
                   '  sample 25/100 (5000.0 s)\n'
                   '  sample 50/100 (5050.0 s)\n'
                   'NUTS: 2 chains, 10 warmup + 100 samples, max depth 7 '
                   '(resuming)...\n'
                   '  sample 75/100 (50.0 s)\n'
                   '  sample 100/100 (100.0 s)\n')
    mod = _load_analyze_nuts()
    wall = mod.sampling_wall_s(str(log), 100)
    assert wall == 200.0     # pooled per-sample rate 2 s x 100


def test_wall_time_too_few_stamps(tmp_path):
    log = tmp_path / 'run.log'
    log.write_text('  sample 25/100 (50.0 s)\n')
    mod = _load_analyze_nuts()
    assert mod.sampling_wall_s(str(log), 100) is None

"""Tests for the Params config layer (L0) — precedence, parsing, JSON IO."""

import json
import os

import pytest

from parasitoids_tpu.config import Params


def test_defaults_kalbar():
    p = Params()
    assert p.dataset == 'kalbar'
    assert p.site_name == 'data/kalbar'
    assert p.start_time == '00:00'
    assert p.r_dur == 1
    assert p.r_number == 130000
    assert p.domain_info == (10000.0, 400)


def test_dataset_switch():
    p = Params()
    p.cmd_line_chg(['--carnarvon'])
    assert p.site_name == 'data/carnarvonearl'
    assert p.start_time == '00:30'
    assert p.r_dur == 5
    assert p.r_number == 40000


def test_cmd_line_values():
    p = Params()
    p.cmd_line_chg(['ndays=4', 'domain_info=(5000.0,200)',
                    'g_params=(1.5, 2.5)', 'lam=0.9', 'n_periods=20'])
    assert p.ndays == 4
    assert p.domain_info == (5000.0, 200)
    assert p.g_params == (1.5, 2.5)
    assert p.lam == 0.9
    assert p.n_periods == 20


def test_cmd_line_r_start_not_silently_ignored():
    # The reference had a ==/= typo making these no-ops (Run.py:293-295);
    # we fix it.
    p = Params()
    p.cmd_line_chg(['r_start=0.25', 'r_number=5000'])
    assert p.r_start == 0.25
    assert p.r_number == 5000


def test_flags():
    p = Params()
    p.cmd_line_chg(['--no_plot', '--no_output', '--pop'])
    assert not p.PLOT
    assert not p.OUTPUT
    assert not p.PROB_MODEL
    p.cmd_line_chg(['--plot', '--output', '--prob'])
    assert p.PLOT and p.OUTPUT and p.PROB_MODEL


def test_unknown_raises():
    p = Params()
    with pytest.raises(ValueError):
        p.cmd_line_chg(['--not_an_option'])
    with pytest.raises(LookupError):
        p.chg_param('bogus_param', '3')


def test_json_roundtrip(tmp_path):
    p = Params()
    p.cmd_line_chg(['ndays=7', 'mu_r=1.5'])
    p.maps_key = 'SECRET'
    out = tmp_path / 'run.json'
    p.save_json(str(out))
    saved = json.loads(out.read_text())
    assert 'maps_key' not in saved  # stripped, as in reference Run.py:515

    q = Params()
    q.file_read_chg(str(out))
    assert q.ndays == 7
    assert q.mu_r == 1.5
    assert tuple(q.domain_info) == (10000.0, 400)


def test_model_param_packers():
    p = Params()
    hparams, Dp, Dlp, mu_r, n_periods, rad_dist, rad_res = p.get_model_params()
    assert hparams == (p.lam, *p.g_params, *p.f_params)
    assert Dp == p.Dparams and Dlp == p.Dlparams
    assert (rad_dist, rad_res) == p.domain_info
    assert p.get_wind_params() == (p.site_name, p.interp_num, p.start_time)


def test_custom_release_weights():
    """Explicit daily release-emergence weights (the reference's 'custom'
    hook is an unimplemented stub, Run.py:164-166): CLI tuple syntax,
    normalization, validation, and the dist_weights the forward setup
    builds from them."""
    import numpy as np
    import pytest

    p = Params()
    p.cmd_line_chg(['--carnarvon', 'r_dur=3', 'r_dist=(1.0,2.0,1.0)'])
    assert p.r_dist == (1.0, 2.0, 1.0)
    dist = p.r_mthd()
    np.testing.assert_allclose([dist(d) for d in (1, 2, 3)],
                               [0.25, 0.5, 0.25])

    # wrong length / negative weights are rejected at use
    p.r_dur = 2
    with pytest.raises(ValueError, match='r_dur'):
        p.r_mthd()
    p.r_dur = 3
    p.r_dist = (1.0, -1.0, 1.0)
    with pytest.raises(ValueError, match='non-negative'):
        p.r_mthd()

    # the 'custom' stub stays reference-faithful but points at the weights
    p.r_dist = 'custom'
    with pytest.raises(NotImplementedError, match='explicit'):
        p.r_mthd()(1)


def test_custom_release_weights_in_forward_setup_and_json(tmp_path):
    import json

    import numpy as np

    from parasitoids_tpu.models.forward import setup_forward

    p = Params()
    p.cmd_line_chg(['dataset=demo', 'domain_info=(2000.0,25)',
                    'r_dur=2', 'r_dist=(0.25,0.75)', 'interp_num=2',
                    'kernel_rad=6', 'kernel_rad_local=3'])
    p.PLOT = False
    p.OUTPUT = False
    p.PROB_MODEL = False
    s = setup_forward(p)
    np.testing.assert_allclose(s.dist_weights, [0.25, 0.75])

    # a list r_dist round-trips through the JSON sidecar
    path = tmp_path / 'run.json'
    with open(path, 'w') as f:
        json.dump({'r_dist': [0.25, 0.75], 'r_dur': 2}, f)
    q = Params()
    q.file_read_chg(str(path))
    assert q.r_mthd()(2) == 0.75


def test_config_txt_preset_owned_keys_survive(tmp_path):
    """config.txt overrides of preset-owned keys must not be clobbered
    (regression: the reference re-runs my_datasets() after the config loop,
    Run.py:202, resetting r_number/outfile/... — wart fixed, not copied)."""
    cfg = tmp_path / 'config.txt'
    cfg.write_text('r_number = 50000\nlam = 0.9\n')
    p = Params()
    p.default_chg(str(cfg))
    assert p.r_number == 50000
    assert p.lam == 0.9


def test_cli_flag_order_independent():
    """--pop/--kalbar re-apply the dataset preset; key=value overrides must
    win regardless of argument order (regression: an override given before
    the flag was silently reset by the preset)."""
    a, b = Params(), Params()
    a.cmd_line_chg(['r_number=5000', 'outfile=output/x', '--pop'])
    b.cmd_line_chg(['--pop', 'r_number=5000', 'outfile=output/x'])
    assert a.r_number == b.r_number == 5000
    assert a.outfile == b.outfile == 'output/x'
    assert a.PROB_MODEL is False and b.PROB_MODEL is False


def test_bool_parse_strict():
    """'no'/'off' parse False; junk raises instead of silently enabling
    (regression: the bool(val) fallthrough turned 'no' into True)."""
    p = Params()
    p.chg_param('plot', 'no')
    assert p.PLOT is False
    p.chg_param('use_f64', 'on')
    assert p.use_f64 is True
    with pytest.raises(ValueError):
        p.chg_param('output', 'nope')

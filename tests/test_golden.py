"""Golden-run regression tests.

The reference gates some tests on a saved sample run (conftest.py:15-20
``data_avail``); SURVEY.md section 4 recommends replacing that with a small
checked-in golden run.  These goldens were produced by the verified CPU
build (tiny Kalbar config: 4 days, 201x201 @ 40 m) and guard against silent
numerical drift in the kernel builder + solver + persistence stack.

Tolerances allow f32 transcendental/FFT differences across backends
(CPU vs GPU) but catch real regressions (both absolute and mass-weighted).
"""

import os

import numpy as np
import pytest

from parasitoids_tpu.config import Params
from parasitoids_tpu.io.save import load_run
from parasitoids_tpu.models.forward import setup_forward, simulate

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')


def _run_config(pop, site='--kalbar', ndays=4):
    p = Params()
    p.cmd_line_chg([site])
    p.PLOT = False
    p.OUTPUT = False
    p.PROB_MODEL = not pop
    p.ndays = ndays
    p.domain_info = (4000.0, 100)
    p.interp_num = 6
    p.kernel_rad = 20
    p.kernel_rad_local = 6
    p.quad_nodes = 12
    return p


@pytest.mark.parametrize('name,pop', [('kalbar_prob_tiny', False),
                                      ('kalbar_pop_tiny', True)])
def test_golden_run(name, pop):
    path = os.path.join(GOLDEN, name)
    want, want_days = load_run(path, 201)
    want = np.stack([np.asarray(w.todense() if hasattr(w, 'todense') else w)
                     for w in want])

    p = _run_config(pop)
    fields, days = simulate(p)
    got = np.asarray(fields)

    assert list(days) == list(want_days)
    scale = max(want.max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)
    # integral parity per day (tighter than pointwise)
    np.testing.assert_allclose(got.sum(axis=(1, 2)), want.sum(axis=(1, 2)),
                               rtol=1e-4)


def test_golden_run_carnarvon_release_ramp():
    """Regression guard on the multi-day-release cohort path (r_dur = 5,
    Carnarvon preset: 40k wasps over 5 days, Run.py:108-124)."""
    path = os.path.join(GOLDEN, 'carnarvon_pop_tiny')
    want, want_days = load_run(path, 201)
    want = np.stack([np.asarray(w.todense() if hasattr(w, 'todense') else w)
                     for w in want])

    p = _run_config(True, site='--carnarvon', ndays=7)
    fields, days = simulate(p)
    got = np.asarray(fields)

    assert list(days) == list(want_days)
    scale = max(want.max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-5)
    np.testing.assert_allclose(got.sum(axis=(1, 2)), want.sum(axis=(1, 2)),
                               rtol=1e-4)
    # release-ramp semantics: mass held at origin keeps day totals at
    # r_number until dispersal losses begin
    totals = got.sum(axis=(1, 2))
    np.testing.assert_allclose(totals[:3], p.r_number, rtol=2e-5)

"""Unit tests for the Bayes-layer building blocks (priors, transforms,
diagnostics) — fast, no forward simulation."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy import stats

from parasitoids_tpu.bayes.diagnostics import (effective_sample_size,
                                               gelman_rubin, geweke)
from parasitoids_tpu.bayes.priors import (ModelParams, ObsParams,
                                          initial_model_params,
                                          initial_obs_params,
                                          log_prior_model, log_prior_obs,
                                          MODEL_PARAM_NAMES)
from parasitoids_tpu.bayes.transforms import (MODEL_TRANSFORMS,
                                              obs_transforms)


def test_prior_finite_at_init():
    m = ModelParams(*jnp.asarray(initial_model_params(), jnp.float32))
    lp = float(log_prior_model(m))
    assert np.isfinite(lp)

    sizes = [127, 79, 58, 130, 314, 81]
    o0 = initial_obs_params(sizes, 25.0 ** 2)
    o = ObsParams(o0[0], o0[1], o0[2], o0[3], jnp.asarray(o0[4:]))
    areas = jnp.asarray([s * 625.0 for s in sizes])
    lp_o = float(log_prior_obs(o, areas, min(sizes) * 625.0))
    assert np.isfinite(lp_o)


def test_prior_rejects_out_of_support():
    m0 = initial_model_params()
    for idx, bad in [(MODEL_PARAM_NAMES.index('lam'), 1.5),
                     (MODEL_PARAM_NAMES.index('sig_x'), -1.0),
                     (MODEL_PARAM_NAMES.index('f_a1'), 12.0),
                     (MODEL_PARAM_NAMES.index('corr_p'), -0.2)]:
        v = m0.copy()
        v[idx] = bad
        lp = float(log_prior_model(ModelParams(*jnp.asarray(v))))
        assert lp == -np.inf, (idx, bad)


def test_prior_matches_scipy_densities():
    """Spot-check the PyMC-2 parameterization conventions against scipy."""
    m0 = initial_model_params()
    base = float(log_prior_model(ModelParams(*jnp.asarray(m0, jnp.float64))))

    def with_(name, val):
        v = m0.copy()
        v[MODEL_PARAM_NAMES.index(name)] = val
        return float(log_prior_model(ModelParams(*jnp.asarray(
            v, jnp.float64))))

    # Gamma(26, 0.15) with beta = rate -> scale 1/0.15
    d = with_('sig_x', 200.0) - base
    want = (stats.gamma.logpdf(200.0, 26, scale=1 / 0.15) -
            stats.gamma.logpdf(m0[MODEL_PARAM_NAMES.index('sig_x')], 26,
                               scale=1 / 0.15))
    np.testing.assert_allclose(d, want, atol=5e-3)  # f32 gammaln

    # Normal(1, tau=1) -> sd 1
    d = with_('mu_r', 1.7) - base
    want = (stats.norm.logpdf(1.7, 1, 1) - stats.norm.logpdf(
        m0[MODEL_PARAM_NAMES.index('mu_r')], 1, 1))
    np.testing.assert_allclose(d, want, atol=5e-3)

    # Poisson(30) pmf ratio
    d = with_('n_periods', 25.0) - base
    want = (stats.poisson.logpmf(25, 30) - stats.poisson.logpmf(30, 30))
    np.testing.assert_allclose(d, want, atol=5e-3)


def test_transforms_roundtrip():
    vals = np.asarray(initial_model_params(), np.float64)
    for i, t in enumerate(MODEL_TRANSFORMS):
        z = t.fwd(jnp.asarray(vals[i]))
        back = float(t.inv(z))
        np.testing.assert_allclose(back, vals[i], rtol=1e-3)  # f32 logit
    for t, v in zip(obs_transforms(2, 1000.0), [0.75, 0.05, 0.005, 250.0,
                                                0.1, 0.2]):
        np.testing.assert_allclose(float(t.inv(t.fwd(jnp.asarray(v)))), v,
                                   rtol=1e-3)


def test_gelman_rubin():
    rng = np.random.default_rng(0)
    same = rng.normal(0, 1, (4, 2000))
    r = gelman_rubin(same)
    assert 0.99 < r < 1.05
    shifted = same + np.arange(4)[:, None] * 3
    assert gelman_rubin(shifted) > 1.5
    with pytest.raises(ValueError):
        gelman_rubin(same[:1])


def test_geweke_stationary_vs_drifting():
    rng = np.random.default_rng(1)
    stat = rng.normal(0, 1, 4000)
    z = geweke(stat)[:, 1]
    assert np.abs(z).max() < 3.5
    drift = stat + np.linspace(0, 6, 4000)
    zd = geweke(drift)[:, 1]
    assert np.abs(zd).max() > 4.0


def test_geweke_segments_stay_out_of_comparison_tail():
    """Regression: start indices must not reach into the final ``last``
    fraction — segments inside the tail compare against themselves (z ~ 0)
    and mask non-convergence."""
    n = 1000
    out = geweke(np.random.default_rng(3).normal(size=n),
                 first=0.1, last=0.5)
    seg_len = int(0.1 * n)
    tail_start = int((1 - 0.5) * n)
    assert (out[:, 0] + seg_len <= tail_start).all()
    # a chain drifting through its first half must be flagged by EVERY
    # early segment, not averaged away by self-comparing late segments
    drift = np.concatenate([np.linspace(8, 0, n // 2),
                            np.random.default_rng(4).normal(size=n // 2)])
    zd = geweke(drift, first=0.1, last=0.5)[:, 1]
    assert np.abs(zd).min() > 2.0


def test_effective_sample_size():
    rng = np.random.default_rng(2)
    iid = rng.normal(0, 1, 4000)
    ess = effective_sample_size(iid)
    assert ess > 2000
    # AR(1) with strong correlation has far fewer effective samples
    ar = np.empty(4000)
    ar[0] = 0
    for i in range(1, 4000):
        ar[i] = 0.95 * ar[i - 1] + rng.normal()
    assert effective_sample_size(ar) < 500


@pytest.mark.slow
def test_map_multistart_beats_or_matches_single(tmp_path):
    """Multi-start MAP (over-dispersed prior starts, best mode wins) must
    do at least as well as the single default-init fit given the same step
    budget — start 0 IS the default init — and report per-start logps."""
    from parasitoids_tpu.bayes.map_fit import map_fit, map_fit_multistart
    from parasitoids_tpu.bayes.model import BayesSetup
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

    single = map_fit(setup, n_steps=30, use_sprd=False)
    multi = map_fit_multistart(setup, n_starts=4, n_steps=30,
                               use_sprd=False, seed=0)
    assert multi['start_logps'].shape == (4,)
    assert 0 <= multi['best_start'] < 4
    assert np.isfinite(multi['logp'])
    # start 0 replicates the deterministic init, so best-of-N can only help
    assert multi['logp'] >= single['logp'] - 0.5

    # sharded over the virtual mesh: same best start, same logp (lax.map
    # per shard is the same computation)
    import jax
    from parasitoids_tpu.parallel.chains import chain_mesh
    multi_sh = map_fit_multistart(setup, n_starts=8, n_steps=10,
                                  use_sprd=False, seed=0,
                                  mesh=chain_mesh())
    multi_1d = map_fit_multistart(setup, n_starts=8, n_steps=10,
                                  use_sprd=False, seed=0)
    assert multi_sh['best_start'] == multi_1d['best_start']
    np.testing.assert_allclose(multi_sh['start_logps'],
                               multi_1d['start_logps'], rtol=1e-5)


@pytest.mark.slow
def test_lbfgs_polish_improves_mode():
    """The L-BFGS polish must not lose log-posterior relative to its Adam
    starting point, and should shrink the gradient norm."""
    import jax
    import jax.numpy as jnp

    from parasitoids_tpu.bayes.map_fit import (_make_objective, lbfgs_polish,
                                               map_fit)
    from parasitoids_tpu.bayes.model import BayesSetup
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

    fit = map_fit(setup, n_steps=40, use_sprd=False)
    polished = lbfgs_polish(setup, fit['z'], n_steps=15, use_sprd=False)
    assert polished['logp'] >= fit['logp'] - 1e-3

    neg, _, _ = _make_objective(setup, False)
    g0 = np.linalg.norm(np.asarray(
        jax.grad(neg)(jnp.asarray(fit['z'], jnp.float32))))
    g1 = np.linalg.norm(np.asarray(
        jax.grad(neg)(jnp.asarray(polished['z'], jnp.float32))))
    assert g1 <= g0 * 1.05


def test_laplace_log_evidence_analytic(monkeypatch):
    """On an exactly Gaussian objective the Laplace marginal likelihood is
    exact; pin the whole formula (free-slot masking, bijection Jacobian,
    normalization constants) against the closed form.

    theta = (2 z0, [fixed], 3 z2) with neg-logpost = 0.5 * sum(a_i z_i^2)
    over the two free slots: the z-space evidence of exp(logp_max - 0.5
    z^T A z) is logp_max + (d/2) log(2pi) - 0.5 log det A, and the
    theta-space evidence adds log|J| = log 2 + log 3."""
    from parasitoids_tpu.bayes import map_fit as M

    a0, a2 = 4.0, 0.25

    def fake_objective(setup, use_sprd, free_n=False):
        def neg_logpost(z):
            return 0.5 * (a0 * z[0] ** 2 + a2 * z[2] ** 2)

        def constrain(z):
            m = jnp.stack([2.0 * z[0], jnp.asarray(7.0), 3.0 * z[2]])
            return m, jnp.zeros(0), None

        def unconstrain(m, o, sprd):
            raise NotImplementedError

        return neg_logpost, constrain, unconstrain

    monkeypatch.setattr(M, '_make_objective', fake_objective)

    class Setup:
        pass

    logp_max = -1.75    # value the caller reports at the mode
    fit = {'z': np.zeros(3, np.float32), 'use_sprd': False,
           'logp': logp_max}
    lap = M.laplace_approximation(Setup(), fit)

    assert lap['free'].tolist() == [True, False, True]
    assert lap['hess_pd']
    expected = (logp_max + np.log(2.0) + np.log(3.0)
                + 0.5 * 2 * np.log(2 * np.pi)
                - 0.5 * np.log(a0 * a2))
    np.testing.assert_allclose(lap['log_evidence'], expected, rtol=1e-5)
    # the fixed slot is regularized away, not counted
    assert lap['cov_z'][1, 1] < 1e-9

    # a saddle (negative curvature) is flagged, not silently reported
    def saddle_objective(setup, use_sprd, free_n=False):
        neg_lp, con, unc = fake_objective(setup, use_sprd)
        return (lambda z: -0.5 * a0 * z[0] ** 2 + 0.5 * a2 * z[2] ** 2,
                con, unc)

    monkeypatch.setattr(M, '_make_objective', saddle_objective)
    lap2 = M.laplace_approximation(Setup(), fit)
    assert not lap2['hess_pd']
    assert np.isnan(lap2['log_evidence'])

"""Minute-sharded single-simulation forward pass (parallel/domain.py):
the sharded builder must match the single-device path — values, loss
accounting, gradients, and the full posterior — on the virtual 8-device
CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from parasitoids_tpu.config import Params
from parasitoids_tpu.models.forward import build_all_kernels, setup_forward
from parasitoids_tpu.parallel.domain import (build_all_kernels_sharded,
                                             minute_mesh)


def _small_params():
    p = Params()
    p.cmd_line_chg(['--kalbar'])
    p.PLOT = False
    p.OUTPUT = False
    p.PROB_MODEL = False
    p.ndays = 3
    p.domain_info = (10000.0, 50)
    p.interp_num = 2            # T = 96 minutes/day, divisible by 8
    p.kernel_rad = 6
    p.kernel_rad_local = 3
    p.quad_nodes = 8
    return p


@pytest.fixture(scope='module')
def fsetup():
    return setup_forward(_small_params())


def _theta(p):
    hp = tuple(jnp.float32(v) for v in (p.lam,) + tuple(p.g_params)
               + tuple(p.f_params))
    Dp = tuple(jnp.float32(v) for v in p.Dparams)
    Dlp = tuple(jnp.float32(v) for v in p.Dlparams)
    return hp, Dp, Dlp, jnp.float32(p.mu_r), jnp.int32(p.n_periods)


def test_sharded_kernels_match_single_device(fsetup):
    p = _small_params()
    hp, Dp, Dlp, mu_r, n_per = _theta(p)
    mesh = minute_mesh()
    assert mesh.devices.size == 8

    ref, ref_loss = build_all_kernels(
        fsetup.wind_flat, fsetup.wind_cumsum, hp, Dp, Dlp, mu_r, n_per,
        fsetup.rad_dist, fsetup.start_idx, fsetup.kcfg, fsetup.ndays)
    got, got_loss = build_all_kernels_sharded(
        mesh, fsetup.wind_flat, fsetup.wind_cumsum, hp, Dp, Dlp, mu_r,
        n_per, fsetup.rad_dist, fsetup.start_idx, fsetup.kcfg, fsetup.ndays)

    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    # partial-sum merge reorders f32 accumulation; agreement to fp tolerance
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(np.asarray(got_loss), np.asarray(ref_loss),
                               atol=1e-6)
    # still pmfs
    np.testing.assert_allclose(got.sum(axis=(1, 2)), 1.0, atol=1e-4)


def test_sharded_uneven_minute_axis(fsetup):
    """T not divisible by the mesh size exercises the zero-block padding."""
    p = _small_params()
    hp, Dp, Dlp, mu_r, n_per = _theta(p)
    mesh = minute_mesh(n_devices=7)      # 96 = 7*13 + 5 -> padded
    ref, _ = build_all_kernels(
        fsetup.wind_flat, fsetup.wind_cumsum, hp, Dp, Dlp, mu_r, n_per,
        fsetup.rad_dist, fsetup.start_idx, fsetup.kcfg, fsetup.ndays)
    got, _ = build_all_kernels_sharded(
        mesh, fsetup.wind_flat, fsetup.wind_cumsum, hp, Dp, Dlp, mu_r,
        n_per, fsetup.rad_dist, fsetup.start_idx, fsetup.kcfg, fsetup.ndays)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-6)


def test_sharded_gradients_match(fsetup):
    """d(kernel mass moments)/d(sig_x, mu_r) through the sharded psum path
    equals the single-device gradient (the property NUTS/MAP rely on)."""
    p = _small_params()
    hp, Dp, Dlp, mu_r, n_per = _theta(p)
    mesh = minute_mesh()
    row_w = jnp.arange(2 * fsetup.kcfg.rad_res + 1, dtype=jnp.float32)

    def moment(kernels):
        return jnp.sum(kernels * row_w[None, :, None])

    def f_single(sig_x, mu):
        k, _ = build_all_kernels(
            fsetup.wind_flat, fsetup.wind_cumsum, hp,
            (sig_x, Dp[1], Dp[2]), Dlp, mu, n_per,
            fsetup.rad_dist, fsetup.start_idx, fsetup.kcfg, fsetup.ndays)
        return moment(k)

    def f_shard(sig_x, mu):
        k, _ = build_all_kernels_sharded(
            mesh, fsetup.wind_flat, fsetup.wind_cumsum, hp,
            (sig_x, Dp[1], Dp[2]), Dlp, mu, n_per,
            fsetup.rad_dist, fsetup.start_idx, fsetup.kcfg, fsetup.ndays)
        return moment(k)

    g_ref = jax.grad(f_single, argnums=(0, 1))(Dp[0], mu_r)
    g_got = jax.grad(f_shard, argnums=(0, 1))(Dp[0], mu_r)
    for a, b in zip(g_got, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=1e-6)


@pytest.mark.slow
def test_forward_mesh_bayes_integration():
    """``BayesSetup.with_forward_mesh`` runs the full projection path
    (remat + day scan + shard_map) and matches the single-device setup.

    The projection fields must agree to fp tolerance.  Log-likelihood
    values are NOT asserted equal everywhere: observed cells whose modeled
    rate sits at the 1e-8 sparsity threshold can flip across it under any
    float-reordering, each flip moving that term by the ~-27.6/count floor
    penalty (model.py ``poisson_logpmf``).  Away from the floor regime the
    terms must agree tightly."""
    from parasitoids_tpu.bayes.model import BayesSetup
    from parasitoids_tpu.bayes.priors import (initial_model_params,
                                              initial_obs_params)
    from parasitoids_tpu.bayes.sampler import _as_model, _as_obs

    setup = BayesSetup(_small_params())
    sharded = setup.with_forward_mesh(minute_mesh())

    m = _as_model(jnp.asarray(initial_model_params(), jnp.float32))
    o0 = initial_obs_params(
        [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
        setup.cell_res ** 2)
    o = _as_obs(jnp.asarray(o0, jnp.float32), setup.n_sent)

    pa = setup.forward_projections(m)
    pb = sharded.forward_projections(m)
    leaves_a = jax.tree_util.tree_leaves(pa)
    leaves_b = jax.tree_util.tree_leaves(pb)
    peak = max(float(np.abs(np.asarray(x)).max()) for x in leaves_a)
    for a, b in zip(leaves_a, leaves_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6 * peak)

    la = np.asarray(setup.pointwise_loglik(pa, o), np.float64)
    lb = np.asarray(sharded.pointwise_loglik(pb, o), np.float64)
    # low-rate cells amplify fp noise logarithmically: a projection
    # difference of ~1e-6*peak (allowed above) is a few log-units on a
    # cell whose rate is near the 1e-8 threshold, so terms in the
    # (-20, -10) band only get a gross-error bound; terms above -10 are
    # far from the threshold and must agree tightly (a wrong psum would
    # shift them by orders)
    healthy = (la > -10.0) & (lb > -10.0)
    assert healthy.mean() > 0.5
    np.testing.assert_allclose(lb[healthy], la[healthy], atol=1e-3)
    band = (la > -20.0) & (lb > -20.0)
    np.testing.assert_allclose(lb[band], la[band], atol=5.0)

    lp_a = float(setup.log_posterior(m, o))
    lp_b = float(sharded.log_posterior(m, o))
    assert np.isfinite(lp_a) and np.isfinite(lp_b)

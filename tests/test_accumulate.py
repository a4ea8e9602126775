"""The day accumulate (``ops/daily_kernel.xla_accumulate_day``) against
independent f64 references: the host BVN oracle (utils/bvn_host.py) for
values, central finite differences for every differentiable input.

The accumulate is the kernel-build layer every forward simulation and
every gradient runs through; on a GPU its scatter-add sums in a
run-dependent order, so these tests pin the arithmetic on the CPU.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from parasitoids_tpu.io import get_wind_data, pack_wind
from parasitoids_tpu.ops.daily_kernel import (KernelConfig,
                                              build_daily_kernel,
                                              day_scatter_inputs,
                                              xla_accumulate_day)
from parasitoids_tpu.utils.bvn_host import bvn_cell_masses_host

HPARAMS = tuple(np.float32(v) for v in (1.0, 1.8, 6.0, 7.0, 2.0, 19.0, 2.0))
RAD_RES, RAD_DIST, K = 60, 1500.0, 10
_WIND = {}


def _wind(interp=2):
    if interp not in _WIND:
        wind_data, days = get_wind_data('data/kalbar', interp, '00:00')
        packed = pack_wind(wind_data, days, ndays=len(days))
        flat = jnp.asarray(packed.reshape(-1, 2), jnp.float32)
        cumsum = jnp.concatenate(
            [jnp.zeros((1, 2), flat.dtype), jnp.cumsum(flat, axis=0)])
        _WIND[interp] = (flat, cumsum, packed.shape[1])
    return _WIND[interp]


def _oracle(h, mu, idx, clipped, Dparams, cell, K, buf_len):
    """f64 host accumulate with the same contract (CLIP start indices)."""
    n = 2 * K + 1
    buf = np.zeros((buf_len, buf_len))
    loss = 0.0
    for t in np.flatnonzero(h):
        block = np.maximum(bvn_cell_masses_host(
            mu[t], *Dparams, cell, K), 0.0)
        r, c = np.clip(idx[t], 0, buf_len - n)
        buf[r:r + n, c:c + n] += h[t] * block
        loss += clipped[t] * h[t] * (1.0 - block.sum())
    return buf, loss


def _day_inputs(day_idx, start, mu_r=0.06, n_periods=10):
    flat, cumsum, T = _wind()
    cfg = KernelConfig(rad_res=RAD_RES, periods=T, K=K, K_local=4, G=8)
    return day_scatter_inputs(flat, cumsum, jnp.int32(day_idx), HPARAMS,
                              jnp.float32(mu_r), jnp.int32(n_periods),
                              jnp.int32(start), cfg, RAD_DIST)


def _check_against_oracle(day_idx, start, Dparams):
    h, mu, idx, clipped, _ = _day_inputs(day_idx, start)
    cell = RAD_DIST / RAD_RES
    buf_len = 2 * RAD_RES + 1 + 4 * K
    buf, loss = xla_accumulate_day(h, mu, idx, clipped, Dparams, cell, K,
                                   8, buf_len, chunk=40)
    h64, mu64 = np.asarray(h, np.float64), np.asarray(mu, np.float64)
    assert h64.sum() > 0          # the day has blocks on the domain
    want, want_loss = _oracle(h64, mu64, np.asarray(idx),
                              np.asarray(clipped, np.float64), Dparams,
                              cell, K, buf_len)
    # f32 corner CDFs are good to ~1e-7 absolute (ops/bvn.py), summed over
    # the few dozen minutes whose blocks overlap a cell
    np.testing.assert_allclose(np.asarray(buf), want, atol=3e-6)
    np.testing.assert_allclose(float(loss), want_loss, atol=3e-6)


@pytest.mark.parametrize('day_idx,start', [(0, 0), (3, 0), (0, 37)])
def test_accumulate_matches_f64_oracle(day_idx, start):
    _check_against_oracle(day_idx, start, (21.1, 10.6, 0.3))


@pytest.mark.parametrize('rho', [0.93, -0.93, 0.99, -0.99])
def test_accumulate_high_rho_matches_f64_oracle(rho):
    """|rho| >= 0.925 takes Genz's asymptotic-series branch."""
    _check_against_oracle(1, 0, (21.1, 10.6, rho))


# ---- gradients against central finite differences, in f64 ---------------

_T, _K, _BUF = 24, 5, 64


def _random_day():
    rng = np.random.default_rng(7)
    n = 2 * _K + 1
    return dict(
        h=rng.uniform(0.0, 1e-3, _T),
        mu=rng.uniform(-12.0, 12.0, (_T, 2)),
        # some interior blocks, some at the clip boundary (idx extremes)
        idx=rng.integers(0, _BUF - n + 1, (_T, 2)).astype(np.int32),
        clipped=rng.integers(0, 2, _T).astype(np.float64),
        w=rng.normal(size=(_BUF, _BUF)),
        Dparams=(21.1, 10.6, 0.35), cell=25.0)


def _objective(d, name):
    """Scalar (w * buf).sum() + 3 loss as a function of one input."""
    def f(x):
        args = dict(h=d['h'], mu=d['mu'], Dparams=d['Dparams'],
                    cell=d['cell'])
        if name in ('sig_x', 'sig_y', 'rho'):
            Dp = list(d['Dparams'])
            Dp[('sig_x', 'sig_y', 'rho').index(name)] = x
            args['Dparams'] = tuple(Dp)
        else:
            args[name] = x
        buf, loss = xla_accumulate_day(
            jnp.asarray(args['h']), jnp.asarray(args['mu']),
            jnp.asarray(d['idx']), jnp.asarray(d['clipped']),
            args['Dparams'], args['cell'], _K, 8, _BUF)
        return (jnp.asarray(d['w']) * buf).sum() + 3.0 * loss
    return f


@pytest.mark.parametrize('name', ['h', 'mu', 'sig_x', 'sig_y', 'rho',
                                  'cell'])
def test_accumulate_vjp_matches_finite_differences(name):
    """Each input's VJP (closed-form BVN CDF derivatives, ops/bvn.py)
    against a central difference along a random direction."""
    with jax.enable_x64(True):
        d = _random_day()
        f = _objective(d, name)
        x0 = {'h': d['h'], 'mu': d['mu'], 'cell': d['cell'],
              'sig_x': d['Dparams'][0], 'sig_y': d['Dparams'][1],
              'rho': d['Dparams'][2]}[name]
        x0 = jnp.asarray(x0, jnp.float64)
        v = jnp.asarray(np.random.default_rng(3).normal(size=x0.shape))
        g = jax.grad(f)(x0)
        directional = float(jnp.sum(g * v))
        eps = 1e-6 * max(1.0, float(jnp.max(jnp.abs(x0))))
        fd = (float(f(x0 + eps * v)) - float(f(x0 - eps * v))) / (2 * eps)
        assert directional != 0.0
        np.testing.assert_allclose(directional, fd, rtol=1e-6)


@pytest.mark.parametrize('rho', [0.3, 0.93])
def test_day_kernel_gradient_matches_finite_differences(rho):
    """The whole day kernel (inputs, accumulate, crop, local remainder,
    renormalization) differentiated in mu_r, sig_x and rho, in f64."""
    with jax.enable_x64(True):
        wind_data, days = get_wind_data('data/kalbar', 2, '00:00')
        packed = pack_wind(wind_data, days, ndays=len(days))
        # shrink the wind so advection stays on the domain (off-domain
        # blocks have zero gradient and would make this test vacuous)
        flat = jnp.asarray(packed.reshape(-1, 2), jnp.float64) * 1e-3
        cumsum = jnp.concatenate(
            [jnp.zeros((1, 2), flat.dtype), jnp.cumsum(flat, axis=0)])
        cfg = KernelConfig(rad_res=30, periods=packed.shape[1], K=6,
                           K_local=3, G=8)
        weights = jnp.arange(61.0)[None, :] ** 2

        def f(theta):
            pmf, loss = build_daily_kernel(
                flat, cumsum, jnp.int32(1),
                tuple(jnp.float64(v) for v in HPARAMS),
                (theta[1], 10.6, theta[2]), (5.8, 5.0, 0.1), theta[0],
                jnp.int32(10), 500.0, jnp.int32(0), cfg)
            return (pmf * weights).sum() + loss

        theta = jnp.asarray([1.1, 21.1, rho], jnp.float64)
        g = np.asarray(jax.grad(f)(theta))
        eye = np.eye(3)
        # eps 1e-4: the O(eps^2) truncation is below the O(1e-16 |f| / eps)
        # rounding of the ~1e3-sized objective only from there up
        fd = np.array([(float(f(theta + 1e-4 * e)) -
                        float(f(theta - 1e-4 * e))) / 2e-4 for e in eye])
        assert np.all(g != 0.0)
        np.testing.assert_allclose(g, fd, rtol=1e-4)

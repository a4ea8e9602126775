"""Minute-sharded single-simulation forward pass (latency scaling).

`parallel/chains.py` and `parallel/ensemble.py` scale *throughput*: each
device runs whole independent simulations.  This module scales *latency* —
ONE forward simulation spread over the mesh — for the workloads where a
single chain's wall-clock is the bottleneck (MAP / NUTS / VI gradient
evaluations, each of which runs exactly one forward simulation per step).

The axis that shards is the kernel builder's flight-minute loop: the
1,440 per-minute BVN blocks of each day (`ops/daily_kernel.py`) are
independent until the scatter-accumulate, so each device builds its minute
shard into a local padded buffer and one `lax.psum` over the mesh merges
them — the classic partial-sum tensor-parallel pattern over the
card-to-card links.  The cheap per-minute precompute and the FFT
propagation phase stay replicated (replicating it costs no extra
wall-clock, and the kernel phase divides by the mesh size).

The reference has no counterpart: its only intra-simulation parallelism is
a `multiprocessing.Pool` over *days* (Run.py:412-429), which cannot help a
single likelihood evaluation inside MCMC.

Use `BayesSetup(..., forward_mesh=mesh)` — or `with_forward_mesh(mesh)` on
an existing setup — to route every posterior evaluation (AM, MAP, NUTS, VI,
PT, SMC rejuvenation) through the sharded builder.  Do NOT combine with the
chain-sharded samplers on the same mesh: those shard the chain axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.daily_kernel import (KernelConfig, day_scatter_inputs, finish_day,
                                xla_accumulate_day)

__all__ = ['minute_mesh', 'build_daily_kernel_sharded',
           'build_all_kernels_sharded']

_AXIS = 'minutes'


def minute_mesh(n_devices=None, devices=None):
    """1-D mesh over a ``minutes`` axis (all devices by default)."""
    from .chains import axis_mesh
    return axis_mesh(_AXIS, n_devices, devices)


def _sharded_accumulate(mesh, h_scat, cdf_mu, idx, clip_f, Dparams, cell,
                        config: KernelConfig, buf_len):
    """Accumulate one day's blocks with the minute axis sharded over
    ``mesh``: per-device partial buffers merged by ``psum``."""
    from jax import shard_map

    n_dev = mesh.shape[_AXIS]
    T = h_scat.shape[0]
    pad = (-T) % n_dev
    if pad:                       # padded minutes scatter h=0 at (0, 0)
        h_scat = jnp.pad(h_scat, (0, pad))
        cdf_mu = jnp.pad(cdf_mu, ((0, pad), (0, 0)))
        idx = jnp.pad(idx, ((0, pad), (0, 0)))
        clip_f = jnp.pad(clip_f, (0, pad))
    t_local = (T + pad) // n_dev

    def local(h, mu, ix, cl, Dp):
        buf, loss = xla_accumulate_day(
            h, mu, ix, cl, Dp, cell, config.K, config.G, buf_len,
            chunk=min(config.chunk, t_local))
        return lax.psum(buf, _AXIS), lax.psum(loss, _AXIS)

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(_AXIS), P(_AXIS), P(_AXIS), P(_AXIS), P()),
                  out_specs=(P(), P()), check_vma=False)
    return f(h_scat, cdf_mu, idx, clip_f, jnp.stack(Dparams))


def build_daily_kernel_sharded(mesh, wind_flat, wind_cumsum, day_idx,
                               hparams, Dparams, Dlparams, mu_r, n_periods,
                               rad_dist, start_idx, config: KernelConfig):
    """Minute-sharded twin of ``ops.daily_kernel.build_daily_kernel`` —
    identical contract and physics; only the accumulation order differs
    (per-device partial sums), so results match to float-summation
    tolerance."""
    K = config.K
    rad_res = config.rad_res
    D = 2 * rad_res + 1
    cell = rad_dist / rad_res

    h_scat, cdf_mu, idx, clip_f, outside_loss = day_scatter_inputs(
        wind_flat, wind_cumsum, day_idx, hparams, mu_r, n_periods,
        start_idx, config, rad_dist)
    buf, clip_loss = _sharded_accumulate(
        mesh, h_scat, cdf_mu, idx, clip_f, Dparams, cell, config, D + 4 * K)
    return finish_day(buf, outside_loss, clip_loss, Dlparams, config,
                      rad_dist)


def build_all_kernels_sharded(mesh, wind_flat, wind_cumsum, hparams,
                              Dparams, Dlparams, mu_r, n_periods, rad_dist,
                              start_idx, config: KernelConfig, ndays: int):
    """All daily kernels with the minute axis sharded — the sharded twin of
    ``models.forward.build_all_kernels``."""

    def day_step(_, d):
        s = jnp.where(d == 0, start_idx, 0)
        pmf, loss = build_daily_kernel_sharded(
            mesh, wind_flat, wind_cumsum, d, hparams, Dparams, Dlparams,
            mu_r, n_periods, rad_dist, s, config)
        return None, (pmf, loss)

    _, (kernels, losses) = lax.scan(day_step, None,
                                    jnp.arange(ndays, dtype=jnp.int32))
    return kernels, losses

"""Daily dispersal-kernel builder (L2 hot path).

Accelerator replacement for the reference's ``prob_mass``
(ParasitoidModel.py:384-613).  The reference loops 1,440 flight minutes in
Python, calling a Fortran integrator with an adaptive window per minute and
scatter-adding variable-size blocks into a sparse host array.  Here the whole
day is one jitted, fixed-shape program:

* per-minute advection means come from a prefix-sum over the concatenated
  multi-day wind array — one gather per minute replaces the reference's
  three-way in-day / next-day-wrap / last-day-extrapolation branching
  (ParasitoidModel.py:439-460) with identical semantics,
* per-minute kernels are built densely on a static ``(2K+1)²`` window by the
  closed-form BVN integrator under ``vmap`` (chunked to bound memory),
* accumulation into the domain is a single windowed ``lax.scatter_add`` with
  CLIP index mode onto a K-cell padded buffer: blocks straddling the domain
  edge are clipped cell-exactly and clipped mass is accounted as ``loss``,
  reproducing the reference's edge handling (ParasitoidModel.py:506-558),
* the "didn't fly" remainder is the local-diffusion kernel scaled by
  ``1 - total_flight_prob`` (ParasitoidModel.py:581-599), and
* small values are dropped and the lost mass redistributed uniformly over the
  surviving support, matching ``CalcSol.r_small_vals(prob_model=True)``
  (CalcSol.py:112-136) which the reference applies to every daily kernel.

The result is a dense ``(2*rad_res+1,)²`` pmf that sums to 1, ready for the
FFT propagation layer.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .bvn import bvn_cell_masses
from .flight import h_flight_prob

__all__ = ['KernelConfig', 'build_daily_kernel', 'day_scatter_inputs',
           'finish_day', 'r_small_vals_dense', 'ring_truncate']

_SECONDS_PER_DAY = 3600 * 24
_NEGVAL = 1e-8  # sparsity threshold, ref CalcSol.py:112

_SCATTER_DNUMS = lax.ScatterDimensionNumbers(
    update_window_dims=(1, 2), inserted_window_dims=(),
    scatter_dims_to_operand_dims=(0, 1))


class KernelConfig(NamedTuple):
    """Static configuration of the kernel builder (shapes & quadrature)."""
    rad_res: int          # cells from release point to domain side
    periods: int          # wind samples per day (48 * interp_num)
    K: int                # flight-kernel window half-width (cells)
    K_local: int          # local-diffusion window half-width (cells)
    G: int = 16           # quadrature nodes per cell column
    chunk: int = 240      # minutes per accumulation chunk (bounds memory)
    # emulate the reference's adaptive ring-expansion stopping rule
    # (cdf_eps=0.001, ParasitoidModel.py:329,348): truncate every
    # per-minute block (and the local-diffusion kernel) to the smallest
    # centered square holding > 0.999 mass, the tail folding into the
    # stay-local remainder exactly as the reference's accounting does.
    # A PARITY TOOL (closes the e2e residual attribution loop, PARITY.md)
    # — not for production runs, where the full window is strictly more
    # accurate.
    ref_trunc: bool = False
    # ensemble-batched BVN scheme (ops/bvn.bvn_cell_masses_batched): the
    # fixed-G two-branch select that a particle-vmap needs to avoid
    # executing all four rho lax.switch branches.
    batched_bvn: bool = False


def r_small_vals_dense(field, prob_model=False, negval=_NEGVAL):
    """Dense equivalent of the reference's sparsifier/renormalizer
    (CalcSol.py:112-136): zero entries below ``negval``; in probability-model
    mode redistribute the removed mass uniformly over the surviving support
    so the field remains a pmf."""
    keep = field >= negval
    kept = jnp.where(keep, field, 0.0)
    if prob_model:
        n_keep = jnp.sum(keep)
        n = jnp.maximum(n_keep, 1)
        kept = kept + jnp.where(keep, (1.0 - kept.sum()) / n, 0.0)
        # degenerate input with NO surviving entries: redistribution has
        # nowhere to go — pass the field through instead of silently
        # annihilating all mass
        kept = jnp.where(n_keep > 0, kept, field)
    return kept


def ring_truncate(block, K: int, cdf_eps: float = 0.001):
    """Truncate a (2K+1)² BVN block to the smallest centered square of
    cells whose cumulative mass exceeds ``1 - cdf_eps`` — the reference's
    adaptive ring-expansion stopping rule (ParasitoidModel.py:329-348:
    ``while 1 - val_sum >= cdf_eps: h += 1``).  If no square reaches the
    threshold inside the window (a boundary-straddling block), the whole
    window is kept, matching the reference's behavior of scattering
    whatever its (there: unbounded) expansion produced."""
    n = 2 * K + 1
    i = jnp.arange(n)
    cheb = jnp.maximum(jnp.abs(i - K)[:, None], jnp.abs(i - K)[None, :])
    ring_sums = jax.ops.segment_sum(block.ravel(), cheb.ravel(),
                                    num_segments=K + 1)
    cum = jnp.cumsum(ring_sums)
    meets = cum > (1.0 - cdf_eps)
    h_star = jnp.where(jnp.any(meets), jnp.argmax(meets), K)
    return jnp.where(cheb <= h_star, block, 0.0)


def _advection_means(wind_flat, wind_cumsum, day_idx, n_periods, periods,
                     mu_r):
    """Windowed mean advection per minute of the day, already scaled to
    flight meters per period (ParasitoidModel.py:439-472).

    The window runs ``n_periods`` samples forward from each minute on the
    concatenated wind timeline, truncating at the end of the data — this
    reproduces the reference's in-day, next-day-wrap and final-day
    extrapolation cases in one expression.
    """
    total = wind_flat.shape[0]
    g0 = day_idx * periods
    t = jnp.arange(periods)
    # n_periods = 0 is inside the Poisson prior's support (the AM proposal
    # only rounds the discrete slot) and would make counts 0 -> NaN fields
    # that silently auto-reject; floor the averaging window at 1 period
    # (the Gibbs-NUTS move clamps the same way, bayes/nuts.py)
    n_periods = jnp.maximum(n_periods, 1)
    starts = g0 + t
    ends = jnp.minimum(starts + n_periods, total)
    counts = (ends - starts).astype(wind_flat.dtype)
    sums = wind_cumsum[ends] - wind_cumsum[starts]        # (T, 2)
    mu_v = sums / counts[:, None]                          # m/s
    # m/s -> meters per flight, scaled by the wind->flight factor
    scale = _SECONDS_PER_DAY * (n_periods.astype(mu_v.dtype) / periods) * mu_r
    return mu_v * scale


@partial(jax.jit, static_argnames=('K', 'G', 'buf_len', 'chunk',
                                   'ref_trunc', 'batched_bvn'))
def xla_accumulate_day(h_scat, cdf_mu, idx, clipped, Dparams, cell,
                       K: int, G: int, buf_len: int, chunk: int = 240,
                       ref_trunc: bool = False, batched_bvn: bool = False):
    """Accumulate all per-minute BVN blocks of one day: chunked ``vmap``
    block build + ``lax.scatter_add`` with CLIP mode (on a GPU, XLA
    lowers the scatter to atomic adds, so the order of the sums changes
    from run to run).  Returns the (buf_len, buf_len) buffer and the
    clipped-block truncation loss sum_t clip_t h_t (1 - bsum_t)."""
    dtype = h_scat.dtype
    T = h_scat.shape[0]
    sig_x, sig_y, rho = Dparams
    from .bvn import bvn_cell_masses_batched
    masses = bvn_cell_masses_batched if batched_bvn else bvn_cell_masses
    if ref_trunc:
        build_block = jax.vmap(
            lambda mu: ring_truncate(
                masses(mu, sig_x, sig_y, rho, cell, K, G), K))
    else:
        build_block = jax.vmap(
            lambda mu: masses(mu, sig_x, sig_y, rho, cell, K, G))

    C = min(chunk, T)
    n_chunks = -(-T // C)
    pad = n_chunks * C - T
    h_p = jnp.pad(h_scat, (0, pad))
    mu_p = jnp.pad(cdf_mu, ((0, pad), (0, 0)))
    idx_p = jnp.pad(idx, ((0, pad), (0, 0)))   # (0,0) is in-bounds, h=0
    cl_p = jnp.pad(clipped, (0, pad))

    # remat per chunk: reverse mode (MAP/NUTS) would otherwise store every
    # quadrature node's (C, 2K+2, 2K+2) exp intermediates across all chunks
    # and days — ~GBs at the full Bayes config (HBM-measured)
    @jax.checkpoint
    def chunk_step(buf, args):
        h_c, mu_c, idx_c, cl_c = args
        blocks = build_block(mu_c)                   # (C, 2K+1, 2K+1)
        b_total = blocks.sum(axis=(1, 2))
        buf = lax.scatter_add(buf, idx_c, blocks * h_c[:, None, None],
                              _SCATTER_DNUMS,
                              mode=lax.GatherScatterMode.CLIP)
        return buf, jnp.sum(cl_c * h_c * (1.0 - b_total))

    buf0 = jnp.zeros((buf_len, buf_len), dtype)
    buf, losses = lax.scan(
        chunk_step, buf0,
        (h_p.reshape(n_chunks, C), mu_p.reshape(n_chunks, C, 2),
         idx_p.reshape(n_chunks, C, 2), cl_p.reshape(n_chunks, C)))
    return buf, losses.sum()


def day_scatter_inputs(wind_flat, wind_cumsum, day_idx, hparams, mu_r,
                       n_periods, start_idx, config: KernelConfig, rad_dist):
    """Per-minute inputs for the day's accumulate: ``(h_scat, cdf_mu, idx,
    clip_f, outside_loss)``.  Cheap elementwise work over the minute axis —
    factored out so the accumulate itself can be minute-sharded over a
    device mesh (parallel/domain.py) without duplicating the physics."""
    T, K = config.periods, config.K
    rad_res = config.rad_res
    cell = rad_dist / rad_res
    dtype = wind_flat.dtype

    n_periods = jnp.asarray(n_periods)

    # --- per-minute take-off probability -------------------------------
    day_idx = jnp.asarray(day_idx, jnp.int32)
    day_wind = lax.dynamic_slice(
        wind_flat, (day_idx * T, jnp.int32(0)), (T, 2))
    windr = jnp.hypot(day_wind[:, 0], day_wind[:, 1])
    lam, aw, bw, a1, b1, a2, b2 = hparams
    hprob = h_flight_prob(windr, lam, aw, bw, a1, b1, a2, b2)
    active = jnp.arange(T) >= start_idx
    h_eff = jnp.where(active, hprob, 0.0)

    # --- per-minute advection and window placement ---------------------
    mu_v = _advection_means(wind_flat, wind_cumsum, day_idx, n_periods, T,
                            mu_r)                                  # (T, 2)
    grid_off = jnp.round(mu_v / cell)
    cdf_mu = mu_v - grid_off * cell                                # (T, 2)
    col_off = grid_off[:, 0].astype(jnp.int32)
    row_off = -grid_off[:, 1].astype(jnp.int32)   # +y decreases row index

    # Blocks whose center is more than K cells beyond the domain edge cannot
    # overlap the domain at all: the reference counts their entire take-off
    # probability as loss (the warning path, ParasitoidModel.py:547-558).
    # Every other block fits the 2K-padded buffer without clamping, so edge
    # clipping is cell-exact and never translates a block.
    outside = ((jnp.abs(row_off) > rad_res + K) |
               (jnp.abs(col_off) > rad_res + K))
    # blocks that straddle the domain boundary (partial, cell-exact clip)
    clipped = (~outside & ((jnp.abs(row_off) + K > rad_res) |
                           (jnp.abs(col_off) + K > rad_res)))
    # scatter start index in the 2K-padded buffer
    idx = jnp.stack(
        [jnp.where(outside, rad_res, rad_res + K + row_off),
         jnp.where(outside, rad_res, rad_res + K + col_off)], axis=1)

    h_scat = jnp.where(outside, 0.0, h_eff)   # fully-outside blocks add 0
    clip_f = clipped.astype(dtype)
    # full take-off probability of blocks entirely off-domain
    # (ref ParasitoidModel.py:546,558)
    outside_loss = jnp.sum(jnp.where(outside, h_eff, 0.0))
    return h_scat, cdf_mu, idx, clip_f, outside_loss


def finish_day(buf, outside_loss, clip_loss, Dlparams, config: KernelConfig,
               rad_dist):
    """Post-accumulate steps shared by the single-device and minute-sharded
    builders: crop the padded buffer, total the loss accounting, add the
    "didn't fly" local-diffusion remainder, sparsify + renormalize."""
    K, Kl, G = config.K, config.K_local, config.G
    rad_res = config.rad_res
    D = 2 * rad_res + 1
    cell = rad_dist / rad_res
    dtype = buf.dtype

    pmf = buf[2 * K:2 * K + D, 2 * K:2 * K + D]
    pad_mass = buf.sum() - pmf.sum()
    # loss = mass scattered beyond the domain, plus window-truncation
    # shortfall of boundary-straddling blocks, plus the full take-off
    # probability of blocks entirely off-domain
    loss = pad_mass + clip_loss + outside_loss

    # --- "didn't fly" local-diffusion remainder ------------------------
    total_flight_prob = pmf.sum() + loss
    sl_x, sl_y, sl_rho = Dlparams
    if getattr(config, 'batched_bvn', False):
        from .bvn import bvn_cell_masses_batched as _masses
    else:
        _masses = bvn_cell_masses
    local = _masses(jnp.zeros(2, dtype), sl_x, sl_y, sl_rho, cell, Kl, G)
    if config.ref_trunc:
        # the reference builds Sl's kernel with the same ring expansion
        # (ParasitoidModel.py:581-584)
        local = ring_truncate(local, Kl)
    stay = jnp.where(total_flight_prob < 0.99999,
                     1.0 - total_flight_prob, 0.0)
    pmf = lax.dynamic_update_slice(
        pmf,
        lax.dynamic_slice(pmf, (rad_res - Kl, rad_res - Kl),
                          (2 * Kl + 1, 2 * Kl + 1)) + stay * local,
        (rad_res - Kl, rad_res - Kl))

    # --- sparsify + renormalize (ref CalcSol.r_small_vals, prob model) --
    pmf = r_small_vals_dense(pmf, prob_model=True)
    return pmf, loss


@partial(jax.jit, static_argnames=('config',))
def build_daily_kernel(wind_flat, wind_cumsum, day_idx, hparams, Dparams,
                       Dlparams, mu_r, n_periods, rad_dist, start_idx,
                       config: KernelConfig):
    """Build one day's dispersal pmf as a dense ``(2*rad_res+1,)²`` array.

    Args:
        wind_flat: (ndays*periods, 2) concatenated interpolated wind (m/s).
        wind_cumsum: (ndays*periods + 1, 2) prefix sum of ``wind_flat``.
        day_idx: which day to build (traced int).
        hparams: (lam, aw, bw, a1, b1, a2, b2) take-off parameters.
        Dparams: (sig_x, sig_y, rho) flight diffusion.
        Dlparams: (sig_x, sig_y, rho) local diffusion.
        mu_r: wind-to-flight advection scaling.
        n_periods: flight duration in wind samples (traced int).
        rad_dist: meters from release point to domain side.
        start_idx: first active minute (release-day start), 0 otherwise.
        config: static shapes/quadrature settings.

    Returns:
        (pmf, loss): the renormalized daily kernel and the probability mass
        advected beyond the domain (before renormalization).
    """
    T, K, G = config.periods, config.K, config.G
    rad_res = config.rad_res
    D = 2 * rad_res + 1
    cell = rad_dist / rad_res

    h_scat, cdf_mu, idx, clip_f, outside_loss = day_scatter_inputs(
        wind_flat, wind_cumsum, day_idx, hparams, mu_r, n_periods,
        start_idx, config, rad_dist)

    buf, clip_loss = xla_accumulate_day(
        h_scat, cdf_mu, idx, clip_f, Dparams, cell,
        K, G, D + 4 * K, chunk=min(config.chunk, T),
        ref_trunc=config.ref_trunc,
        batched_bvn=getattr(config, 'batched_bvn', False))

    return finish_day(buf, outside_loss, clip_loss, Dlparams, config,
                      rad_dist)

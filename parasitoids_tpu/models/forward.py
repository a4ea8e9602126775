"""End-to-end forward simulation (L2+L3 assembly).

Replaces the reference driver pipeline (Run.main, Run.py:388-487): wind →
per-day dispersal kernels → FFT-chained daily fields.  The reference fans
``prob_mass`` across a multiprocessing pool and chains solutions on the host
(or GPU); here kernel construction is a ``lax.scan`` over days (each day
internally vmapped over minutes) and propagation is the Fourier-space scan —
one device program end to end, reusable inside the Bayesian likelihood.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import Params
from ..io import get_wind_data, pack_wind
from ..ops.daily_kernel import KernelConfig, build_daily_kernel
from .solver import SolverConfig, propagate_pop, propagate_prob

__all__ = ['ForwardSetup', 'setup_forward', 'build_all_kernels',
           'simulate', 'forward_fields']


class ForwardSetup(NamedTuple):
    """Host-side preparation of a simulation: packed wind + static configs."""
    wind_flat: jnp.ndarray     # (ndays*T, 2)
    wind_cumsum: jnp.ndarray   # (ndays*T + 1, 2)
    days: tuple                # day labels from the wind file
    ndays: int
    kcfg: KernelConfig
    scfg: SolverConfig
    rad_dist: float
    start_idx: int             # release start minute on day 0 (pop model)
    dist_weights: np.ndarray   # (r_dur,) release emergence distribution


def _auto_half_width(Dparams, cell, z=4.0, lo=6):
    """Window half-width in cells covering ~z sigma of a diffusion kernel."""
    sig = max(float(Dparams[0]), float(Dparams[1]))
    return max(lo, int(np.ceil(z * sig / cell)) + 1)


def setup_forward(params: Params, dtype=None) -> ForwardSetup:
    """Load wind and freeze static configuration from a Params object.

    ``dtype`` defaults to f32, or f64 when ``params.use_f64`` is set
    (validation mode, SURVEY.md section 7 step 3 — the reference CPU path
    is f64); f64 also flips JAX's global x64 mode."""
    if dtype is None:
        if getattr(params, 'use_f64', False):
            jax.config.update('jax_enable_x64', True)
            dtype = jnp.float64
        else:
            dtype = jnp.float32
    wind_data, days = get_wind_data(*params.get_wind_params())
    ndays = len(days) if params.ndays < 0 else min(params.ndays, len(days))
    packed = pack_wind(wind_data, days, ndays=len(days))
    T = packed.shape[1]
    flat = jnp.asarray(packed.reshape(-1, 2), dtype)
    cumsum = jnp.concatenate(
        [jnp.zeros((1, 2), flat.dtype), jnp.cumsum(flat, axis=0)])
    rad_dist, rad_res = params.domain_info
    cell = rad_dist / rad_res
    # Static kernel-window half-widths: auto-sized to ~4 sigma of this
    # run's diffusion parameters (covers the reference's adaptive 0.999
    # -mass stopping rule, ParasitoidModel.py:329-348, with margin) unless
    # pinned.  Callers whose sigma varies under jit (the Bayes layer) must
    # pin a prior-coverage width instead (bayes/model.py).
    K = (params.kernel_rad if params.kernel_rad is not None
         else _auto_half_width(params.Dparams, cell))
    Kl = (params.kernel_rad_local if params.kernel_rad_local is not None
          else _auto_half_width(params.Dlparams, cell, lo=3))
    kcfg = KernelConfig(rad_res=int(rad_res), periods=T,
                        K=int(K), K_local=int(Kl),
                        G=params.quad_nodes,
                        ref_trunc=bool(getattr(params, 'ref_trunc', False)))
    scfg = SolverConfig.for_domain(int(rad_res))
    if (not params.PROB_MODEL) and params.r_start is not None:
        start_idx = int(params.r_start * T)
    else:
        start_idx = 0
    if params.r_dur:
        w = np.array([params.r_mthd()(d + 1) for d in range(params.r_dur)])
    else:
        if not params.PROB_MODEL:
            # dataset=None leaves r_dur unset; the ones(1) placeholder
            # would die later in an opaque int(None)/scatter traceback
            raise ValueError(
                'the population model requires r_dur >= 1 (release '
                'duration in days) — pick a dataset preset/site spec or '
                'pass r_dur=N')
        w = np.ones(1)
    return ForwardSetup(flat, cumsum, tuple(days), ndays, kcfg, scfg,
                        float(rad_dist), start_idx, w)


@partial(jax.jit, static_argnames=('kcfg', 'ndays'))
def build_all_kernels(wind_flat, wind_cumsum, hparams, Dparams, Dlparams,
                      mu_r, n_periods, rad_dist, start_idx, kcfg: KernelConfig,
                      ndays: int):
    """Build every day's dispersal kernel — the reference's pool fan-out
    (Run.py:412-447) as a scan over days; returns ((ndays, D, D), losses)."""

    def day_step(_, d):
        s = jnp.where(d == 0, start_idx, 0)
        pmf, loss = build_daily_kernel(wind_flat, wind_cumsum, d, hparams,
                                       Dparams, Dlparams, mu_r, n_periods,
                                       rad_dist, s, kcfg)
        return None, (pmf, loss)

    _, (kernels, losses) = lax.scan(day_step, None,
                                    jnp.arange(ndays, dtype=jnp.int32))
    return kernels, losses


@partial(jax.jit, static_argnames=('kcfg', 'scfg', 'ndays', 'r_dur',
                                   'prob_model'))
def forward_fields(wind_flat, wind_cumsum, hparams, Dparams, Dlparams, mu_r,
                   n_periods, rad_dist, start_idx, r_number, dist_weights,
                   kcfg: KernelConfig, scfg: SolverConfig, ndays: int,
                   r_dur: int, prob_model: bool):
    """Fused kernel-build + propagation as one standalone device program —
    the library's single-call forward simulation (used by the driver
    compile check, ``__graft_entry__.entry``).  The MCMC likelihood
    composes the same building blocks itself (bayes/model.py
    ``forward_projections``) because it adds sprd_factor and optional
    minute-axis sharding this signature doesn't carry."""
    kernels, _ = build_all_kernels(wind_flat, wind_cumsum, hparams, Dparams,
                                   Dlparams, mu_r, n_periods, rad_dist,
                                   start_idx, kcfg, ndays)
    if prob_model:
        return propagate_prob(kernels, scfg)
    return propagate_pop(kernels, r_dur, r_number, dist_weights, scfg)


def simulate(params: Params, setup: ForwardSetup | None = None,
             timing: dict | None = None):
    """Run the full forward model for a Params config.

    Returns (fields, days): per-day domain fields as a (ndays, D, D) array
    (probability pmfs or expected populations) and the day labels.
    """
    import time as _time
    if setup is None:
        setup = setup_forward(params)
    fdtype = setup.wind_flat.dtype
    hparams = tuple(np.asarray(v, fdtype)
                    for v in (params.lam, *params.g_params, *params.f_params))

    tic = _time.time()
    kernels, losses = build_all_kernels(
        setup.wind_flat, setup.wind_cumsum, hparams, params.Dparams,
        params.Dlparams, params.mu_r,
        jnp.int32(params.n_periods), setup.rad_dist,
        jnp.int32(setup.start_idx if not params.PROB_MODEL else 0),
        setup.kcfg, setup.ndays)
    kernels.block_until_ready()
    if timing is not None:
        timing['kernel_phase'] = _time.time() - tic

    tic = _time.time()
    if params.PROB_MODEL:
        fields = propagate_prob(kernels, setup.scfg)
    else:
        fields = propagate_pop(kernels, int(params.r_dur),
                               float(params.r_number),
                               jnp.asarray(setup.dist_weights,
                                           kernels.dtype), setup.scfg)
    fields.block_until_ready()
    if timing is not None:
        timing['conv_phase'] = _time.time() - tic

    days = list(setup.days)[:setup.ndays]
    from ..utils.checks import warn_on_loss
    warn_on_loss(losses, days)   # ref ParasitoidModel.py:547-558
    return fields, days

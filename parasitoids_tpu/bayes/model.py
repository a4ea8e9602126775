"""Bayesian model assembly (L4): log-posterior over the full forward sim.

Replaces the reference's PyMC model graph (Bayes_Run.py:199-473) with two
jitted functions:

* ``forward_projections(theta_model)`` — the reference's ``pop_model``
  deterministic (Bayes_Run.py:204-336): full forward population simulation
  plus observation projections, entirely on device, re-run for every
  proposed model-parameter block;
* ``log_likelihood(projections, theta_obs)`` — the thinned-Poisson
  observation model (Bayes_Run.py:344-433), cheap to re-evaluate when only
  observation parameters move (mirroring PyMC's per-stochastic step
  structure where obs-parameter updates reuse the cached deterministic).

The optional Kalbar pre-wind spread day (``sprd_factor``,
Bayes_Run.py:241-267 — disabled for MCMC, active in Bayes_MAP.py:200-277)
prepends a mixture kernel of drifted flight spread and local spread.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.scipy.special import gammaln, xlogy

from ..config import Params
from ..io.locinfo import LocInfo
from ..models.forward import ForwardSetup, setup_forward
from ..models.observe import ObservationOps
from ..models.solver import propagate_pop
from ..ops.bvn import bvn_cell_masses
from ..ops.daily_kernel import build_daily_kernel
from .priors import (ModelParams, ObsParams, log_prior_model, log_prior_obs)

__all__ = ['BayesSetup', 'poisson_loglik', 'prior_coverage_windows',
           'negbin_logpmf', 'zip_logpmf']

# Static kernel windows for the MCMC likelihood: sigma varies per proposal
# inside one compiled program, so the window must cover the PRIOR, not one
# sample.  Criterion: >= 3.3 sigma — the radius where the reference's
# adaptive ring expansion stops under its 0.999-mass rule
# (cdf_eps, ParasitoidModel.py:329-348) — at the prior's 0.9999 quantile:
#   sig_x  ~ Gamma(26, 0.15): q_0.9999 = 329 m -> 3.3 sigma = 1086 m
#   sig_xl ~ Gamma(2, 0.08):  q_0.9999 = 147 m -> 3.3 sigma =  485 m
# (Bayes_Run.py:116,123).  Proposals beyond that quantile (1e-4 of prior
# mass) still get >= 3.2 sigma coverage, i.e. <= ~0.2% kernel-mass
# truncation — within the reference's own accuracy budget.
_FLIGHT_COVER_M = 1090.0
_LOCAL_COVER_M = 490.0


def prior_coverage_windows(cell_m):
    """(kernel_rad, kernel_rad_local) in cells for a given cell size —
    the static window half-widths the Bayes likelihood (and any benchmark
    of it) must use."""
    return (int(np.ceil(_FLIGHT_COVER_M / cell_m)),
            int(np.ceil(_LOCAL_COVER_M / cell_m)))


def poisson_logpmf(obs, rate):
    """Elementwise independent Poisson log-pmfs (PyMC flib equivalent).

    Rates are floored at 1e-12: thresholded fields produce exact zeros, and
    a zero rate under a positive count is a hard -inf in the reference's
    PyMC model (instant rejection) but poisons autodiff two ways —
    ``xlogy``'s gradient is x/y (NaN at 0/0, inf at obs/0) — so the floor
    keeps the value a soft, steep penalty (~ -27.6 per observed count)
    while every gradient stays finite for MAP/NUTS."""
    floor = jnp.asarray(1e-12, rate.dtype)
    safe_rate = jnp.maximum(rate, floor)
    ll = jnp.where(obs > 0, xlogy(obs, safe_rate), 0.0)
    return ll - rate - gammaln(obs + 1.0)


def poisson_loglik(obs, rate):
    """Sum of independent Poisson log-pmfs (see ``poisson_logpmf``)."""
    return jnp.sum(poisson_logpmf(obs, rate))


def negbin_logpmf(obs, rate, r):
    """Negative-binomial log-pmfs, mean ``rate`` and dispersion ``r``
    (var = rate + rate²/r; r → ∞ recovers Poisson) — the overdispersed
    observation variant (``Params.obs_model = 'negbin'``).  Same 1e-12
    rate floor as ``poisson_logpmf`` for autodiff-safe zero rates."""
    floor = jnp.asarray(1e-12, rate.dtype)
    mu = jnp.maximum(rate, floor)
    lograte = jnp.log(r + mu)
    ll = (gammaln(obs + r) - gammaln(r) - gammaln(obs + 1.0)
          + r * (jnp.log(r) - lograte)
          + jnp.where(obs > 0, obs * (jnp.log(mu) - lograte), 0.0))
    return ll


def zip_logpmf(obs, rate, pi):
    """Zero-inflated-Poisson log-pmfs: with probability ``pi`` the count
    is a structural zero, else Poisson(rate) (``Params.obs_model =
    'zip'``) — the zero-inflation repair the round-3 PPC asked for
    (release[0]/sentinel[0] zero_frac p ≈ 0.01/0.03)."""
    pi = jnp.clip(pi, 1e-7, 1.0 - 1e-7)
    lp0 = jnp.logaddexp(jnp.log(pi),
                        jnp.log1p(-pi) + poisson_logpmf(
                            jnp.zeros_like(obs), rate))
    lpk = jnp.log1p(-pi) + poisson_logpmf(obs, rate)
    return jnp.where(obs > 0, lpk, lp0)


class BayesSetup:
    """Everything needed to evaluate the posterior for one site/domain."""

    def __init__(self, params: Params | None = None, sprd_factor=None,
                 dtype=None, forward_mesh=None):
        if params is None:
            params = Params()
            params.cmd_line_chg(['--kalbar'])
            params.PLOT = False
            params.OUTPUT = False
            params.PROB_MODEL = False
            params.domain_info = (10000.0, 400)  # Bayes_Run.py:91
        self.params = params
        self.sprd_factor = sprd_factor  # None, or a fixed/initial value
        # observation model: 'poisson' (reference, Bayes_Run.py:344-433)
        # or the overdispersed/zero-inflated variants (config.py
        # obs_model); variants append ONE extra obs-parameter slot (the
        # NB dispersion / ZIP inflation prob) after the sentinel probs
        self.obs_model = getattr(params, 'obs_model', 'poisson')
        self.n_extra_obs = 0 if self.obs_model == 'poisson' else 1
        # optional 1-D mesh: shard every forward simulation's flight-minute
        # axis over it (parallel/domain.py) — latency scaling for
        # single-chain samplers; leave None for chain-sharded sampling
        self.forward_mesh = forward_mesh
        # optional per-observation 0/1 weights (rel, sent, grid block
        # structure) excluding held-out data from the likelihood — the
        # exact cross-validation refit target (bayes/cv.py)
        self.obs_mask = None
        cell = params.domain_info[0] / params.domain_info[1]
        K, Kl = prior_coverage_windows(cell)
        if params.kernel_rad is None:
            params.kernel_rad = K
        if params.kernel_rad_local is None:
            params.kernel_rad_local = Kl
        # dtype=None lets setup_forward honor use_f64 validation mode
        # (which also flips jax_enable_x64); default is f32
        self.setup: ForwardSetup = setup_forward(params, dtype=dtype)
        dtype = self.setup.wind_flat.dtype
        self.locinfo = LocInfo(params.dataset, params.coord,
                               params.domain_info)
        self.ndays = self.setup.ndays
        self.obs_ops = ObservationOps(self.locinfo, params.domain_info,
                                      self.ndays)

        res = params.domain_info[0] / params.domain_info[1]
        cell_area = res * res
        self.cell_res = res
        self.field_areas = jnp.asarray(
            [self.locinfo.field_sizes[k] * cell_area
             for k in self.locinfo.sent_ids], dtype)
        self.min_field_area = float(
            min(self.locinfo.field_sizes.values()) * cell_area)
        self.n_sent = len(self.locinfo.sent_ids)

        # observed data (device constants)
        self.obs_sentinel = [jnp.asarray(a, dtype)
                             for a in self.locinfo.sentinel_emerg]
        self.obs_release = [jnp.asarray(a, dtype)
                            for a in self.locinfo.release_emerg]
        self.obs_grid = jnp.asarray(self.locinfo.grid_obs, dtype)
        self.release_effort = [jnp.asarray(a, dtype)
                               for a in self.locinfo.release_collection]
        self.grid_samples = jnp.asarray(self.locinfo.grid_samples, dtype)

        self.dist_weights = jnp.asarray(self.setup.dist_weights, dtype)
        self.r_dur = int(params.r_dur)
        self.r_number = float(params.r_number)

    # ------------------------------------------------------------------
    def with_observations(self, obs):
        """Shallow copy of this setup with the observed data replaced
        (same shapes/dtypes) — the SBC replicate constructor
        (bayes/sbc.py): a synthetic dataset from
        ``predictive.simulate_observations`` becomes a new inference
        target while every expensive precomputation (forward setup,
        observation operators, location data) is shared.  The copy is a
        distinct jit cache key, so its likelihood retraces (identical HLO
        hits the persistent XLA compilation cache; no recompile)."""
        import copy
        dtype = self.obs_grid.dtype
        new = copy.copy(self)
        rel = [jnp.asarray(a, dtype) for a in obs['release']]
        sent = [jnp.asarray(a, dtype) for a in obs['sentinel']]
        grid = jnp.asarray(obs['grid'], dtype)
        for got, ref, name in (
                (rel, self.obs_release, 'release'),
                (sent, self.obs_sentinel, 'sentinel'),
                ([grid], [self.obs_grid], 'grid')):
            if len(got) != len(ref) or any(
                    g.shape != r.shape for g, r in zip(got, ref)):
                raise ValueError('observation shapes for {!r} do not match '
                                 'this setup'.format(name))
        new.obs_release = rel
        new.obs_sentinel = sent
        new.obs_grid = grid
        return new

    def obs_pytree(self, obs):
        """Validate a ``predictive.simulate_observations`` dict against this
        setup's observation shapes and return it as the traced
        ``(rel, sent, grid)`` structure ``log_likelihood`` accepts as its
        ``obs`` argument.

        Unlike ``with_observations`` (a new static jit key whose data
        compile in as HLO constants — a full XLA recompile per dataset),
        data passed this way are ordinary traced operands: ONE compiled
        program serves every replicate dataset.  This is what makes
        simulation-based calibration (bayes/sbc.py) tractable — 40
        replicates share one compile instead of paying ~40 s each."""
        dtype = self.obs_grid.dtype
        rel = tuple(jnp.asarray(a, dtype) for a in obs['release'])
        sent = tuple(jnp.asarray(a, dtype) for a in obs['sentinel'])
        grid = jnp.asarray(obs['grid'], dtype)
        for got, ref, name in (
                (rel, self.obs_release, 'release'),
                (sent, self.obs_sentinel, 'sentinel'),
                ((grid,), (self.obs_grid,), 'grid')):
            if len(got) != len(ref) or any(
                    g.shape != r.shape for g, r in zip(got, ref)):
                raise ValueError('observation shapes for {!r} do not match '
                                 'this setup'.format(name))
        return rel, sent, grid

    def split_point_mask(self, keep_flat):
        """Reshape a flat boolean vector over the pointwise columns (in
        ``pointwise_loglik`` order: release blocks row-major, sentinel
        blocks, grid) into the ``(rel, sent, grid)`` 0/1-weight structure
        ``log_likelihood`` consumes.  The result is ordinary device data —
        pass it as the traced ``obs_mask`` argument (one compiled program
        serves every mask value, the property bayes/cv.py's per-fold
        refits rely on) or bake it in via ``with_held_out``."""
        keep_flat = np.asarray(keep_flat, bool)
        dtype = self.obs_grid.dtype
        masks_rel, masks_sent = [], []
        pos = 0
        for data in self.obs_release:
            n = int(np.prod(data.shape))
            masks_rel.append(jnp.asarray(
                keep_flat[pos:pos + n].reshape(data.shape), dtype))
            pos += n
        for data in self.obs_sentinel:
            n = int(np.prod(data.shape))
            masks_sent.append(jnp.asarray(
                keep_flat[pos:pos + n].reshape(data.shape), dtype))
            pos += n
        n = int(np.prod(self.obs_grid.shape))
        mask_grid = jnp.asarray(
            keep_flat[pos:pos + n].reshape(self.obs_grid.shape), dtype)
        pos += n
        if pos != keep_flat.shape[0]:
            raise ValueError('keep_flat has {} entries; expected {}'.format(
                keep_flat.shape[0], pos))
        return (tuple(masks_rel), tuple(masks_sent), mask_grid)

    def with_held_out(self, keep_flat):
        """Shallow copy whose ``log_likelihood`` only scores the
        observations where ``keep_flat`` is True — the refit target for
        exact leave-one-group-out cross-validation (bayes/cv.py).

        The prior and forward model are untouched; only the masked
        Poisson terms drop out (data, projections and ``pointwise_loglik``
        itself stay complete, so held-out terms can still be evaluated on
        the refit posterior).  NOTE: the copy is a new static jit key and
        its masks compile in as constants — fine for one-off use; loops
        over many masks should pass ``split_point_mask(...)`` as the
        traced ``obs_mask`` argument instead (one compile total)."""
        import copy
        new = copy.copy(self)
        new.obs_mask = self.split_point_mask(keep_flat)
        return new

    def with_forward_mesh(self, mesh):
        """Shallow copy routing every forward simulation through the
        minute-sharded builder (parallel/domain.py) on ``mesh`` — the copy
        is a distinct jit cache key, so likelihoods retrace with the
        sharded program."""
        import copy
        new = copy.copy(self)
        new.forward_mesh = mesh
        return new

    def with_batched_bvn(self):
        """Shallow copy whose forward simulations use the ensemble-batched
        BVN scheme (ops/bvn.bvn_cell_masses_batched: fixed-G two-branch
        select instead of the rho ``lax.switch``) — the kernel
        configuration a particle-``vmap``
        (bayes/ensemble.py) needs so a batched program executes two BVN
        branch bodies instead of all four.  The copy is a distinct jit
        cache key; single-particle use of it is a pessimization."""
        import copy
        new = copy.copy(self)
        new.setup = self.setup._replace(
            kcfg=self.setup.kcfg._replace(batched_bvn=True))
        return new

    # ------------------------------------------------------------------
    def _pre_spread_kernel(self, m: ModelParams, sprd_factor):
        """Kalbar pre-wind local-spread kernel (Bayes_Run.py:243-267):
        sprd_factor of the population drifts with the flight covariance
        around a fixed mean wind displacement, the rest spreads locally."""
        res = self.cell_res
        kcfg = self.setup.kcfg
        D = 2 * kcfg.rad_res + 1
        drift = np.array([-25.0, 15.0])
        dint = np.floor(drift / res).astype(int)        # cell offsets (x, y)
        drem = drift - dint * res                        # sub-cell remainder
        K, Kl, G = kcfg.K, kcfg.K_local, kcfg.G
        if getattr(kcfg, 'batched_bvn', False):
            from ..ops.bvn import bvn_cell_masses_batched as _masses
        else:
            _masses = bvn_cell_masses
        long_spread = _masses(jnp.asarray(drem), m.sig_x, m.sig_y,
                              m.corr, res, K, G)
        short_spread = _masses(jnp.zeros(2), m.sig_xl, m.sig_yl,
                               m.corr_l, res, Kl, G)
        field = jnp.zeros((D, D), long_spread.dtype)
        c = kcfg.rad_res
        # rows shift by -y drift, cols by +x drift (screen coordinates)
        field = lax.dynamic_update_slice(
            field, sprd_factor * long_spread,
            (c - int(dint[1]) - K, c + int(dint[0]) - K))
        patch = lax.dynamic_slice(field, (c - Kl, c - Kl),
                                  (2 * Kl + 1, 2 * Kl + 1))
        field = lax.dynamic_update_slice(
            field, patch + (1.0 - sprd_factor) * short_spread,
            (c - Kl, c - Kl))
        field = field.at[c, c].add(jnp.maximum(0.0, 1.0 - field.sum()))
        return field

    @partial(jax.jit, static_argnums=(0,))
    def forward_projections(self, m: ModelParams, sprd_factor=None):
        """Run the full population model for a model-parameter block and
        project to observables (the reference ``pop_model``)."""
        s = self.setup
        n_per = jnp.round(m.n_periods).astype(jnp.int32)

        mesh = getattr(self, 'forward_mesh', None)

        @jax.checkpoint
        def day_pmf(d):
            # remat: reverse-mode (MAP gradients, NUTS) recomputes each
            # day's kernel instead of storing the per-minute CDF tensors
            # (~GBs/day at full config)
            start = jnp.where(d == 0, jnp.int32(s.start_idx), 0)
            if mesh is not None:
                from ..parallel.domain import build_daily_kernel_sharded
                pmf, _ = build_daily_kernel_sharded(
                    mesh, s.wind_flat, s.wind_cumsum, d, m.hparams(),
                    m.Dparams(), m.Dlparams(), m.mu_r, n_per, s.rad_dist,
                    start, s.kcfg)
            else:
                pmf, _ = build_daily_kernel(
                    s.wind_flat, s.wind_cumsum, d, m.hparams(), m.Dparams(),
                    m.Dlparams(), m.mu_r, n_per, s.rad_dist, start, s.kcfg)
            return pmf

        _, kernels = lax.scan(lambda _, d: (None, day_pmf(d)), None,
                              jnp.arange(self.ndays, dtype=jnp.int32))

        if sprd_factor is not None:
            pre = self._pre_spread_kernel(m, sprd_factor)
            kernels = jnp.concatenate([pre[None], kernels], axis=0)
            fields = propagate_pop(kernels, self.r_dur, self.r_number,
                                   self.dist_weights, s.scfg)[1:]
        else:
            fields = propagate_pop(kernels, self.r_dur, self.r_number,
                                   self.dist_weights, s.scfg)

        rel, sent = self.obs_ops.project_emergence(fields)
        grid = self.obs_ops.project_grid(fields)
        return tuple(rel), tuple(sent), grid

    # ------------------------------------------------------------------
    @partial(jax.jit, static_argnums=(0,))
    def log_likelihood(self, projections, o: ObsParams, obs_mask=None,
                       obs=None):
        """Thinned-Poisson observation likelihood (Bayes_Run.py:344-433).
        Masked observations contribute nothing: ``obs_mask`` is a traced
        ``(rel, sent, grid)`` 0/1-weight structure (``split_point_mask``),
        falling back to the baked-in ``self.obs_mask`` (``with_held_out``)
        when omitted.  ``obs``: optional traced ``(rel, sent, grid)``
        observed-data structure (``obs_pytree``) replacing the baked-in
        dataset — one compiled program serves every dataset value (the
        SBC replicate path)."""
        rel, sent, grid = projections
        mask = obs_mask if obs_mask is not None else self.obs_mask
        m_rel, m_sent, m_grid = (mask if mask is not None
                                 else (None, None, None))
        data_rel, data_sent, data_grid = (
            obs if obs is not None
            else (self.obs_release, self.obs_sentinel, self.obs_grid))
        lp = 0.0
        for k, (model, data, effort) in enumerate(
                zip(rel, data_rel, self.release_effort)):
            rate = o.xi * model * (effort * o.em_obs_prob)[:, None]
            ll = self._obs_logpmf(data, rate, o)
            lp += jnp.sum(ll if m_rel is None else ll * m_rel[k])
        for k, (model, data) in enumerate(zip(sent, data_sent)):
            rate = o.xi * model * o.sent_obs_probs[:, None]
            ll = self._obs_logpmf(data, rate, o)
            lp += jnp.sum(ll if m_sent is None else ll * m_sent[k])
        grid_rate = o.grid_obs_prob * self.grid_samples * grid
        ll = self._obs_logpmf(data_grid, grid_rate, o)
        lp += jnp.sum(ll if m_grid is None else ll * m_grid)
        return lp

    def _obs_logpmf(self, data, rate, o: ObsParams):
        """Per-count observation log-pmf under the configured observation
        model (static dispatch: ``self`` is a static jit argument)."""
        if self.obs_model == 'negbin':
            return negbin_logpmf(data, rate, o.od)
        if self.obs_model == 'zip':
            return zip_logpmf(data, rate, o.od)
        return poisson_logpmf(data, rate)

    @partial(jax.jit, static_argnums=(0,))
    def pointwise_loglik(self, projections, o: ObsParams):
        """Per-observation Poisson log-pmfs as one flat vector (release
        blocks row-major, then sentinel blocks, then the grid counts) —
        the pointwise decomposition WAIC / PSIS-LOO need (bayes/loo.py).
        ``pointwise_loglik(...).sum() == log_likelihood(...)`` up to float
        summation order."""
        rel, sent, grid = projections
        parts = []
        for model, data, effort in zip(rel, self.obs_release,
                                       self.release_effort):
            rate = o.xi * model * (effort * o.em_obs_prob)[:, None]
            parts.append(self._obs_logpmf(data, rate, o).ravel())
        for model, data in zip(sent, self.obs_sentinel):
            rate = o.xi * model * o.sent_obs_probs[:, None]
            parts.append(self._obs_logpmf(data, rate, o).ravel())
        grid_rate = o.grid_obs_prob * self.grid_samples * grid
        parts.append(self._obs_logpmf(self.obs_grid, grid_rate, o).ravel())
        return jnp.concatenate(parts)

    @partial(jax.jit, static_argnums=(0,))
    def log_posterior(self, m: ModelParams, o: ObsParams, sprd_factor=None,
                      obs=None):
        """Full joint log posterior; -inf outside prior support without
        running the forward model.  ``obs``: optional traced observed-data
        structure (``obs_pytree``) replacing the baked-in dataset — see
        ``log_likelihood``."""
        lp_m = log_prior_model(m)
        lp_o = log_prior_obs(o, self.field_areas, self.min_field_area,
                             self.obs_model)
        prior = lp_m + lp_o

        def run(_):
            proj = self.forward_projections(m, sprd_factor)
            return self.log_likelihood(proj, o, obs=obs)

        loglik = lax.cond(jnp.isfinite(prior), run,
                          lambda _: jnp.asarray(-jnp.inf, prior.dtype),
                          operand=None)
        return prior + loglik

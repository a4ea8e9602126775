"""Adaptive Metropolis MCMC (L4), jit-compiled.

Replaces PyMC 2.x's sampling machinery (Bayes_Run.py:484-537):

* the 15 model parameters are block-updated with an adaptive multivariate
  normal proposal — initial covariance ``diag(step_scales²)`` exactly as the
  reference seeds ``AdaptiveMetropolis`` (Bayes_Run.py:188-196,486-487),
  then Haario-style adaptation from streaming chain moments every step after
  a warm-up, with the 2.38²/d optimal scaling and shrink-on-stall; the
  discrete ``n_periods`` component is rounded in the proposal, as PyMC's AM
  does for discrete stochastics,
* every accepted block evaluation re-runs the full forward simulation
  (the expensive deterministic), exactly like the reference,
* observation parameters (xi, em/grid obs probs, A_collected, per-field
  sentinel probs) get individual random-walk updates that *reuse the cached
  forward projections* — mirroring PyMC's per-stochastic step methods where
  only the Poisson rates recompute,
* one ``lax.scan`` per chain over steps; chains are ``vmap``-ed and can be
  sharded across devices (parallel/chains.py).

The whole sampler — forward model included — is one compiled XLA program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, random

from .model import BayesSetup
from .priors import (ModelParams, ObsParams, STEP_SCALES,
                     initial_model_params, initial_obs_params,
                     log_prior_model, log_prior_obs)

__all__ = ['MCMCConfig', 'ChainState', 'init_chain_state', 'run_mcmc',
           'mcmc_step']

_N_MODEL = 15
_DISCRETE_IDX = 13        # n_periods position in the block
_ADAPT_START = 500        # steps before switching to empirical covariance
_OPT_SCALE = 2.38 ** 2 / _N_MODEL


class MCMCConfig(NamedTuple):
    # NOTE: no pre-spread (``sprd_factor``) option here by design — the
    # reference's MCMC never samples it either (disabled/None in
    # Bayes_Run.py:168-175; it is a MAP-only prior, Bayes_MAP.py:200-205).
    # The pre-spread day is supported in map_fit.py and nuts.py.
    n_samples: int
    adapt_start: int = _ADAPT_START
    obs_scale: float = 0.05       # relative RW scale for obs parameters
    # Metropolis-within-Gibbs sweeps over the obs block per model-block
    # step.  Obs updates reuse the cached forward projections (only the
    # Poisson rates recompute), so extra sweeps cost ~nothing next to the
    # full forward simulation of the model block — but they directly
    # shorten the autocorrelation time along the weakly-identified
    # xi x obs-prob likelihood ridge (where one sweep per step leaves
    # finite-chain rank bias visible in SBC).
    obs_sweeps: int = 1


class ChainState(NamedTuple):
    m: jnp.ndarray            # (15,) model block
    o: jnp.ndarray            # (4 + n_sent,) obs params
    loglik: jnp.ndarray       # cached likelihood at (m, o)
    prior_m: jnp.ndarray
    prior_o: jnp.ndarray
    proj: tuple               # cached forward projections at m
    key: jnp.ndarray
    # streaming moments of the model block (Welford)
    count: jnp.ndarray
    mean: jnp.ndarray         # (15,)
    m2: jnp.ndarray           # (15, 15)
    accepts_m: jnp.ndarray
    accepts_o: jnp.ndarray
    # log of the global proposal-scale factor, Robbins–Monro-adapted toward
    # the 0.234 optimal acceptance rate once the empirical-covariance phase
    # begins — the role of PyMC AM's ``shrink_if_necessary``
    # (Bayes_Run.py:486-487), as a smooth two-sided version
    # (Andrieu & Thoms 2008 algorithm 4)
    log_scale: jnp.ndarray


def _as_model(vec) -> ModelParams:
    return ModelParams(*[vec[i] for i in range(_N_MODEL)])


def _as_obs(vec, n_sent) -> ObsParams:
    # vectors from an obs-model variant carry ONE extra trailing slot (the
    # NB dispersion / ZIP inflation prob); the shape test is static under
    # jit, so plain-Poisson programs are unchanged
    od = vec[4 + n_sent] if vec.shape[0] > 4 + n_sent else 0.0
    return ObsParams(vec[0], vec[1], vec[2], vec[3], vec[4:4 + n_sent], od)


def init_chain_state(setup: BayesSetup, key, m0=None, o0=None,
                     obs_mask=None, obs=None):
    """Evaluate the model at the initial point and build the chain state.
    ``obs_mask``: optional traced likelihood mask (model.py
    ``split_point_mask``) — the cross-validation refit path.
    ``obs``: optional traced observed-data structure (model.py
    ``obs_pytree``) — the SBC replicate path (one compile for all
    replicate datasets)."""
    if m0 is None:
        m0 = initial_model_params()
    if o0 is None:
        cell_area = setup.cell_res ** 2
        o0 = initial_obs_params(
            [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
            cell_area, getattr(setup, 'obs_model', 'poisson'))
    m0 = jnp.asarray(m0, jnp.float32)
    o0 = jnp.asarray(o0, jnp.float32)
    m = _as_model(m0)
    o = _as_obs(o0, setup.n_sent)
    proj = setup.forward_projections(m)
    loglik = setup.log_likelihood(proj, o, obs_mask, obs)
    return ChainState(
        m=m0, o=o0, loglik=loglik,
        prior_m=log_prior_model(m),
        prior_o=log_prior_obs(o, setup.field_areas, setup.min_field_area,
                              getattr(setup, 'obs_model', 'poisson')),
        proj=proj, key=key,
        count=jnp.zeros((), jnp.float32),
        mean=jnp.zeros(_N_MODEL), m2=jnp.zeros((_N_MODEL, _N_MODEL)),
        accepts_m=jnp.zeros((), jnp.float32),
        accepts_o=jnp.zeros((), jnp.float32),
        log_scale=jnp.zeros((), jnp.float32))


def _proposal_chol(state, adapt_start):
    """Proposal covariance: seeded diag(scales²), switching to the scaled
    empirical covariance once enough history exists (Haario AM)."""
    seed = jnp.diag(jnp.asarray(STEP_SCALES, jnp.float32) ** 2)
    emp = state.m2 / jnp.maximum(state.count - 1.0, 1.0)
    adapted = (_OPT_SCALE * jnp.exp(state.log_scale) * emp
               + 1e-9 * jnp.eye(_N_MODEL))
    use_emp = state.count >= adapt_start
    cov = jnp.where(use_emp, adapted, seed)
    return jnp.linalg.cholesky(cov)


def _obs_sweep(setup: BayesSetup, key, o_vec, prior_o, ll_cur, proj,
               beta, cfg: MCMCConfig, obs_mask=None, obs=None,
               n_sweeps=1):
    """One Metropolis-within-Gibbs sweep over the observation block,
    reusing cached forward projections (only the Poisson rates recompute
    — PyMC's per-stochastic step methods, Bayes_Run.py:486-487).

    The proposal is a relative-scale random walk: coordinate ``j`` moves
    by ``N(0, s(o_j)²)`` with ``s(x) = max(|x|, 1e-3) * cfg.obs_scale``.
    Because the scale depends on the *current* state, the proposal is
    asymmetric and the accept ratio needs the Metropolis–Hastings
    correction ``log q(o|o') - log q(o'|o)``; without it the walk's
    invariant measure picks up a ~1/s(x) factor, biasing every
    observation probability toward 0 and dragging xi up the xi*p
    likelihood ridge (found by the round-2 SBC study: all obs-block rank
    histograms skewed with p < 1e-4 while the symmetric-proposal model
    block stayed uniform).

    Returns ``(key, o_vec, prior_o, ll_cur, n_accepts)``.

    The coordinate loop (and the ``n_sweeps`` repetitions) run as one
    ``lax.scan`` over the coordinate index, so the compiled program holds
    a single likelihood subgraph no matter how many sweeps are requested
    — a Python-unrolled loop at obs_sweeps=8 x ~19 coordinates was
    inlining ~152 copies and multiplying compile time accordingly.
    """
    n_sent = setup.n_sent
    n_obs = 4 + n_sent + getattr(setup, 'n_extra_obs', 0)

    def body(carry, j):
        key, o_vec, prior_o, ll_cur, acc_o = carry
        key, k1, k2 = random.split(key, 3)
        s_fwd = jnp.maximum(jnp.abs(o_vec[j]), 1e-3) * cfg.obs_scale
        step = s_fwd * random.normal(k1)
        o_prop = o_vec.at[j].add(step)
        s_rev = jnp.maximum(jnp.abs(o_prop[j]), 1e-3) * cfg.obs_scale
        o_p = _as_obs(o_prop, n_sent)
        prior_p = log_prior_obs(o_p, setup.field_areas,
                                setup.min_field_area,
                                getattr(setup, 'obs_model', 'poisson'))

        ll_p = lax.cond(
            jnp.isfinite(prior_p),
            lambda _: setup.log_likelihood(proj, o_p, obs_mask, obs),
            lambda _: jnp.asarray(-jnp.inf, ll_cur.dtype), operand=None)
        # reverse move draws from N(o', s_rev²): the log-normal-density
        # difference is the Hastings term for the state-dependent scale
        hastings = (jnp.log(s_fwd) - jnp.log(s_rev)
                    + step ** 2 / (2.0 * s_fwd ** 2)
                    - step ** 2 / (2.0 * s_rev ** 2))
        ratio = ((prior_p + beta * ll_p)
                 - (prior_o + beta * ll_cur) + hastings)
        acc = jnp.log(random.uniform(k2)) < ratio
        o_vec = jnp.where(acc, o_prop, o_vec)
        prior_o = jnp.where(acc, prior_p, prior_o)
        ll_cur = jnp.where(acc, ll_p, ll_cur)
        return (key, o_vec, prior_o, ll_cur, acc_o + acc), None

    j_seq = jnp.tile(jnp.arange(n_obs), n_sweeps)
    carry0 = (key, o_vec, prior_o, ll_cur, jnp.zeros((), jnp.float32))
    (key, o_vec, prior_o, ll_cur, acc_o), _ = lax.scan(body, carry0, j_seq)
    return key, o_vec, prior_o, ll_cur, acc_o


def _mcmc_step(setup: BayesSetup, state: ChainState, cfg: MCMCConfig,
               beta=1.0, obs_mask=None, obs=None):
    """One AM transition targeting ``prior + beta * loglik``.

    ``beta`` is the inverse temperature: 1.0 is the posterior (the only
    value the reference's AdaptiveMetropolis ever targets); ``beta < 1``
    tempers the *likelihood only* (priors stay exact, so every tempered
    chain still lives on the prior support) — used by the replica-exchange
    sampler in ``tempering.py``.  ``state.loglik`` stays untempered.
    ``obs_mask``: optional traced likelihood mask (cross-validation
    refits) — must match the mask the chain state was initialized with.
    ``obs``: optional traced observed-data structure (model.py
    ``obs_pytree``) — must match the data the chain state was initialized
    with; lets many datasets share one compiled program (SBC).
    """
    n_sent = setup.n_sent
    beta = jnp.asarray(beta, jnp.float32)
    key, k_prop, k_acc = random.split(state.key, 3)

    # ---- model block update (full forward sim) ----------------------
    chol = _proposal_chol(state, cfg.adapt_start)
    eps = random.normal(k_prop, (_N_MODEL,))
    m_prop_vec = state.m + jnp.matmul(chol, eps,
                                      precision=lax.Precision.HIGHEST)
    m_prop_vec = m_prop_vec.at[_DISCRETE_IDX].set(
        jnp.round(m_prop_vec[_DISCRETE_IDX]))
    m_prop = _as_model(m_prop_vec)
    prior_prop = log_prior_model(m_prop)

    def eval_prop(_):
        proj = setup.forward_projections(m_prop)
        ll = setup.log_likelihood(proj, _as_obs(state.o, n_sent), obs_mask,
                                  obs)
        return ll, proj

    def skip(_):
        return jnp.asarray(-jnp.inf, state.loglik.dtype), state.proj

    ll_prop, proj_prop = lax.cond(jnp.isfinite(prior_prop), eval_prop, skip,
                                  operand=None)
    log_ratio = ((prior_prop + beta * ll_prop)
                 - (state.prior_m + beta * state.loglik))
    accept = jnp.log(random.uniform(k_acc)) < log_ratio

    m_new = jnp.where(accept, m_prop_vec, state.m)
    proj_new = jax.tree.map(lambda a, b: jnp.where(accept, a, b),
                            proj_prop, state.proj)
    ll_new = jnp.where(accept, ll_prop, state.loglik)
    prior_m_new = jnp.where(accept, prior_prop, state.prior_m)

    # streaming moments over the (post-update) chain position
    count = state.count + 1.0
    delta = m_new - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + jnp.outer(delta, m_new - mean)
    # proposal-scale adaptation toward 0.234 acceptance, active with the
    # empirical covariance (diminishing Robbins–Monro steps)
    gamma = jnp.where(count >= cfg.adapt_start,
                      1.0 / jnp.sqrt(count - cfg.adapt_start + 1.0), 0.0)
    log_scale = state.log_scale + gamma * (
        accept.astype(jnp.float32) - 0.234)

    # ---- observation-parameter sweeps (cached projections) -----------
    key, o_vec, prior_o, ll_cur, acc_sweeps = _obs_sweep(
        setup, key, state.o, state.prior_o, ll_new, proj_new, beta, cfg,
        obs_mask, obs, n_sweeps=cfg.obs_sweeps)
    acc_o = state.accepts_o + acc_sweeps

    new_state = ChainState(
        m=m_new, o=o_vec, loglik=ll_cur, prior_m=prior_m_new,
        prior_o=prior_o, proj=proj_new, key=key, count=count, mean=mean,
        m2=m2, accepts_m=state.accepts_m + accept, accepts_o=acc_o,
        log_scale=log_scale)
    sample = jnp.concatenate([
        m_new, o_vec,
        jnp.stack([prior_m_new + prior_o + ll_cur])])
    return new_state, sample


# public alias for the tempering layer (beta-parameterized transition)
mcmc_step = _mcmc_step


@partial(jax.jit, static_argnames=('setup', 'cfg'))
def run_mcmc(setup: BayesSetup, state: ChainState, cfg: MCMCConfig,
             obs=None):
    """Advance one chain ``cfg.n_samples`` steps.

    Returns (final_state, trace) where trace rows are
    ``[model params(15), obs params, log_posterior]``.
    ``obs``: optional traced observed-data structure (model.py
    ``obs_pytree``) replacing the setup's baked-in dataset — one compiled
    program serves every dataset value (the SBC replicate path)."""
    def step(s, _):
        return _mcmc_step(setup, s, cfg, obs=obs)

    return lax.scan(step, state, None, length=cfg.n_samples)

"""MAP estimation and Laplace (normal) approximation (L4).

Replaces the reference's ``Bayes_MAP.py``: ``pm.MAP.fit`` did gradient-free
optimization with hand-tuned finite-difference steps (``prior_eps``,
Bayes_MAP.py:101-205) where every objective evaluation re-ran the full
forward simulation; here the posterior is differentiated end to end with
autodiff and optimized with Adam in an unconstrained reparameterization —
strictly more information per forward pass.  As in the reference,
``n_periods`` is held fixed at 30 during optimization (Bayes_MAP.py:144-147)
and the Kalbar pre-spread factor is an additional Uniform(0,1) parameter
(Bayes_MAP.py:200-205).

``laplace_approximation`` mirrors ``pm.NormApprox`` (Bayes_MAP.py:521-569):
mean = MAP point, covariance = inverse negative Hessian of the log posterior.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax

from .model import BayesSetup
from .priors import (MODEL_PARAM_NAMES, OBS_PARAM_NAMES,
                     initial_model_params, initial_obs_params)
from .sampler import _as_model, _as_obs, _N_MODEL
from .transforms import MODEL_TRANSFORMS, Unit, obs_transforms

__all__ = ['map_fit', 'map_fit_multistart', 'lbfgs_polish',
           'laplace_approximation', 'map_report']

_N_PERIODS_FIXED = 30.0



def default_use_sprd(params):
    """Whether the pre-wind local-spread day (sprd_factor) is fit: on for
    Kalbar as in the reference (Bayes_MAP.py:200-205 — a day of local
    spread before wind data began); generic sites opt in with
    ``"sprd_factor": true`` in their site spec (config.use_sprd_factor)."""
    return (params.dataset == 'kalbar'
            or bool(getattr(params, 'use_sprd_factor', False)))

def _theta_split(setup):
    n_sent = setup.n_sent
    t_obs = obs_transforms(n_sent, setup.min_field_area,
                           getattr(setup, 'obs_model', 'poisson'))
    return n_sent, MODEL_TRANSFORMS, t_obs


def _make_objective(setup: BayesSetup, use_sprd, free_n=False,
                    traced_obs=False):
    """Negative log posterior over the unconstrained vector z.

    ``free_n=True`` returns two-argument callables ``constrain(z, n)`` /
    ``neg_logpost(z, n)`` with the discrete ``n_periods`` slot supplied as
    a traced operand instead of pinned at 30 — the target for
    Gibbs-within-NUTS (bayes/nuts.py); ``n`` enters ``log_posterior``
    through the model vector, so its Poisson(30) prior term (priors.py) is
    included automatically.

    ``traced_obs=True`` instead returns ``neg_logpost(z, obs)`` with the
    observed dataset a traced operand (``BayesSetup.obs_pytree``
    structure) — one compiled program serves every dataset value (the
    SBC replicate path; ``with_observations`` would bake each dataset in
    as HLO constants and recompile per replicate)."""
    if free_n and traced_obs:
        raise ValueError('free_n and traced_obs are mutually exclusive')
    n_sent, t_m, t_o = _theta_split(setup)
    n_obs = 4 + n_sent + getattr(setup, 'n_extra_obs', 0)
    sprd_t = Unit()

    def constrain(z, n_periods=jnp.asarray(_N_PERIODS_FIXED)):
        m_vec = jnp.stack([
            t.inv(z[i]) if i != 13 else
            jnp.asarray(n_periods, z.dtype)
            for i, t in enumerate(t_m)])
        o_vec = jnp.stack([t_o[j].inv(z[_N_MODEL + j])
                           for j in range(n_obs)])
        sprd = sprd_t.inv(z[-1]) if use_sprd else None
        return m_vec, o_vec, sprd

    def _neg_logpost(z, n_periods, obs=None):
        m_vec, o_vec, sprd = constrain(z, n_periods)
        lp = setup.log_posterior(_as_model(m_vec), _as_obs(o_vec, n_sent),
                                 sprd, obs=obs)
        return -lp

    if free_n:
        neg_logpost = _neg_logpost
    elif traced_obs:
        def neg_logpost(z, obs):
            return _neg_logpost(z, jnp.asarray(_N_PERIODS_FIXED), obs)
    else:
        def neg_logpost(z):
            return _neg_logpost(z, jnp.asarray(_N_PERIODS_FIXED))

    def unconstrain(m_vec, o_vec, sprd):
        parts = [jnp.stack([t.fwd(m_vec[i]) if i != 13 else 0.0
                            for i, t in enumerate(t_m)]),
                 jnp.stack([t_o[j].fwd(o_vec[j]) for j in range(n_obs)])]
        if use_sprd:
            parts.append(jnp.stack([sprd_t.fwd(sprd)]))
        return jnp.concatenate(parts)

    return neg_logpost, constrain, unconstrain


def map_fit(setup: BayesSetup, n_steps=300, learning_rate=0.02,
            use_sprd=None, m0=None, o0=None, sprd0=0.3, chunk_steps=25):
    """Optimize the posterior mode.  Returns a dict with the constrained
    estimates, the log posterior at the mode, and the optimization trace.

    The optimization is dispatched in bounded chunks of ``chunk_steps``
    Adam steps per device program (chunking is mathematically a no-op,
    same pattern as the MCMC/NUTS stepwise drivers)."""
    if use_sprd is None:
        use_sprd = default_use_sprd(setup.params)
    neg_logpost, constrain, unconstrain = _make_objective(setup, use_sprd)

    if m0 is None:
        m0 = initial_model_params()
    if o0 is None:
        o0 = initial_obs_params(
            [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
            setup.cell_res ** 2, getattr(setup, 'obs_model', 'poisson'))
    z0 = unconstrain(jnp.asarray(m0, jnp.float32),
                     jnp.asarray(o0, jnp.float32),
                     jnp.asarray(sprd0, jnp.float32))

    opt = optax.adam(learning_rate)

    @partial(jax.jit, static_argnames='length')
    def run_chunk(z, opt_state, length):
        def step(carry, _):
            z, opt_state = carry
            loss, grad = jax.value_and_grad(neg_logpost)(z)
            grad = jnp.where(jnp.isfinite(grad), grad, 0.0)
            updates, opt_state = opt.update(grad, opt_state)
            return (optax.apply_updates(z, updates), opt_state), loss

        (z, opt_state), losses = lax.scan(step, (z, opt_state), None,
                                          length=length)
        return z, opt_state, losses

    final_logp = jax.jit(lambda z: -neg_logpost(z))

    z, opt_state = z0, opt.init(z0)
    losses = []
    done = 0
    while done < n_steps:
        length = min(chunk_steps, n_steps - done)
        # block per chunk: async dispatch would otherwise enqueue every
        # chunk at once, the queue-depth equivalent of one program
        z, opt_state, chunk_losses = jax.block_until_ready(
            run_chunk(z, opt_state, length))
        losses.append(np.asarray(chunk_losses))
        done += length
    losses = np.concatenate(losses) if losses else np.zeros(0)
    m_vec, o_vec, sprd = jax.jit(constrain)(z)
    logp = float(final_logp(z))
    n_params = _N_MODEL - 1 + len(o_vec) + (1 if use_sprd else 0)
    return {
        'z': np.asarray(z),
        'model': np.asarray(m_vec),
        'obs': np.asarray(o_vec),
        'sprd_factor': float(sprd) if use_sprd else None,
        'logp': logp,
        'AIC': 2 * n_params - 2 * logp,    # ref Bayes_MAP.py:494-517
        'losses': np.asarray(losses),
        'use_sprd': use_sprd,
    }


def lbfgs_polish(setup: BayesSetup, z, n_steps=30, use_sprd=None,
                 chunk_steps=10):
    """Quasi-Newton refinement of a MAP point: L-BFGS with zoom linesearch
    (optax) from an Adam solution ``z``.  Adam's constant-step endgame
    wanders around the mode; the curvature-aware polish drives the
    gradient toward machine zero, which sharpens the Laplace covariance
    and the AIC (both second-order quantities around the mode).  Returns a
    ``map_fit``-shaped dict."""
    if use_sprd is None:
        use_sprd = default_use_sprd(setup.params)
    neg_logpost, constrain, _ = _make_objective(setup, use_sprd)
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(neg_logpost)

    @partial(jax.jit, static_argnames='length')
    def run_chunk(z, opt_state, length):
        def step(carry, _):
            z, opt_state = carry
            value, grad = value_and_grad(z, state=opt_state)
            grad = jnp.where(jnp.isfinite(grad), grad, 0.0)
            updates, opt_state = opt.update(
                grad, opt_state, z, value=value, grad=grad,
                value_fn=neg_logpost)
            return (optax.apply_updates(z, updates), opt_state), value

        (z, opt_state), vals = lax.scan(step, (z, opt_state), None,
                                        length=length)
        return z, opt_state, vals

    z = jnp.asarray(z, jnp.float32)
    opt_state = opt.init(z)
    losses = []
    done = 0
    while done < n_steps:
        length = min(chunk_steps, n_steps - done)
        z, opt_state, vals = jax.block_until_ready(
            run_chunk(z, opt_state, length))
        losses.append(np.asarray(vals))
        done += length
    m_vec, o_vec, sprd = jax.jit(constrain)(z)
    logp = float(jax.jit(lambda zz: -neg_logpost(zz))(z))
    n_params = _N_MODEL - 1 + len(o_vec) + (1 if use_sprd else 0)
    return {
        'z': np.asarray(z),
        'model': np.asarray(m_vec),
        'obs': np.asarray(o_vec),
        'sprd_factor': float(sprd) if use_sprd else None,
        'logp': logp,
        'AIC': 2 * n_params - 2 * logp,
        'losses': np.concatenate(losses) if losses else np.zeros(0),
        'use_sprd': use_sprd,
    }


def map_fit_multistart(setup: BayesSetup, n_starts=8, seed=0, n_steps=300,
                       learning_rate=0.02, use_sprd=None, chunk_steps=25,
                       mesh=None, verbose=False):
    """Global MAP search: ``n_starts`` Adam runs from over-dispersed
    starting points, best mode wins.

    The posterior is multimodal (the motivation for the PT/SMC samplers);
    the reference's single-start ``pm.MAP.fit`` — and our ``map_fit`` —
    can land in a side mode.  Start 0 is the deterministic reference
    initialization; the rest draw from the exact joint prior.  Starts run
    through ``lax.map`` (NOT ``vmap``: a theta-batched forward pass pays
    every rho ``lax.switch`` branch, parallel/chains.py) and shard over a
    mesh like any embarrassingly parallel axis.

    Returns the best start's ``map_fit``-shaped dict plus ``'start_logps'``
    (per-start final log posterior) and ``'best_start'``.
    """
    from jax import random

    from .priors import sample_prior_model, sample_prior_obs

    if use_sprd is None:
        use_sprd = default_use_sprd(setup.params)
    neg_logpost, constrain, unconstrain = _make_objective(setup, use_sprd)

    m0 = jnp.asarray(initial_model_params(), jnp.float32)
    o0 = jnp.asarray(initial_obs_params(
        [setup.locinfo.field_sizes[k] for k in setup.locinfo.sent_ids],
        setup.cell_res ** 2, getattr(setup, 'obs_model', 'poisson')),
        jnp.float32)
    k_m, k_o, k_s = random.split(random.PRNGKey(seed), 3)
    ms = jnp.concatenate([
        m0[None], jax.vmap(sample_prior_model)(
            random.split(k_m, n_starts - 1))]) if n_starts > 1 else m0[None]
    os_ = jnp.concatenate([
        o0[None], jax.vmap(lambda k: sample_prior_obs(
            k, setup.field_areas, setup.min_field_area,
            getattr(setup, 'obs_model', 'poisson')))(
                random.split(k_o, n_starts - 1))]) if n_starts > 1 \
        else o0[None]
    # sprd_factor is Uniform(0,1) (Bayes_MAP.py:200-205) — draw it like
    # every other coordinate so the starts are over-dispersed in that
    # dimension too; start 0 keeps the deterministic 0.3
    sprds = jnp.concatenate([
        jnp.full((1,), 0.3, jnp.float32),
        random.uniform(k_s, (n_starts - 1,), jnp.float32, 0.02, 0.98)]) \
        if n_starts > 1 else jnp.full((1,), 0.3, jnp.float32)
    z0s = jax.vmap(unconstrain)(ms, os_, sprds)        # (N, dim)

    opt = optax.adam(learning_rate)

    def one_chunk(z, opt_state, length):
        def step(carry, _):
            z, opt_state = carry
            loss, grad = jax.value_and_grad(neg_logpost)(z)
            grad = jnp.where(jnp.isfinite(grad), grad, 0.0)
            updates, opt_state = opt.update(grad, opt_state)
            return (optax.apply_updates(z, updates), opt_state), loss

        (z, opt_state), losses = lax.scan(step, (z, opt_state), None,
                                          length=length)
        return z, opt_state, losses[-1]

    @partial(jax.jit, static_argnames='length')
    def run_chunk_all(zs, opt_states, length):
        return lax.map(lambda a: one_chunk(a[0], a[1], length),
                       (zs, opt_states))

    def sharded_chunk(zs, opt_states, length):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        spec = P(mesh.axis_names[0])
        f = shard_map(
            lambda z, s: run_chunk_all(z, s, length), mesh=mesh,
            in_specs=(spec, spec), out_specs=(spec, spec, spec),
            check_vma=False)
        return f(zs, opt_states)

    zs = z0s
    opt_states = jax.vmap(opt.init)(z0s)
    done = 0
    last = None
    runner = sharded_chunk if mesh is not None else run_chunk_all
    while done < n_steps:
        length = min(chunk_steps, n_steps - done)
        zs, opt_states, last = jax.block_until_ready(
            runner(zs, opt_states, length))
        done += length
        if verbose:
            print('multistart: {}/{} steps, best -logp {:.2f}'.format(
                done, n_steps, float(jnp.min(last))), flush=True)

    logps = np.asarray(-last, np.float64)
    best = int(np.argmax(logps))
    z_best = zs[best]
    m_vec, o_vec, sprd = jax.jit(constrain)(z_best)
    logp = float(jax.jit(lambda z: -neg_logpost(z))(z_best))
    n_params = _N_MODEL - 1 + len(o_vec) + (1 if use_sprd else 0)
    return {
        'z': np.asarray(z_best),
        'model': np.asarray(m_vec),
        'obs': np.asarray(o_vec),
        'sprd_factor': float(sprd) if use_sprd else None,
        'logp': logp,
        'AIC': 2 * n_params - 2 * logp,
        'losses': np.zeros(0),
        'use_sprd': use_sprd,
        'start_logps': logps,
        'best_start': best,
    }


def hessian_columns(f, z):
    """Full Hessian of scalar ``f`` at ``z`` as SEQUENTIAL Hessian-vector
    products (``lax.map`` of forward-over-reverse JVPs of the gradient).

    ``jax.hessian`` batches all d JVP columns through the model at once —
    at the full 801² Bayes config that is d ≈ 31 copies of the forward
    graph's residuals (23.8 GB requested).  One HVP at a time costs one
    fwd+grad of memory and d× the time — for a one-time 31-column Hessian,
    seconds."""
    grad_fn = jax.grad(f)

    def hvp(v):
        return jax.jvp(grad_fn, (z,), (v,))[1]

    return jax.jit(lambda: lax.map(hvp, jnp.eye(z.shape[0],
                                                dtype=z.dtype)))()


def prior_var_z(setup: BayesSetup, use_sprd=False, n=4000, seed=0):
    """Monte-Carlo prior variances of the UNCONSTRAINED parameter vector
    (the z-space packing of ``_make_objective``), via the exact prior
    samplers.  Deliberately-pinned slots (the fixed ``n_periods``, packed
    as the constant 0) come out exactly 0 — the property the spectral
    floor in ``regularize_cov_z`` relies on to leave them pinned."""
    from jax import random

    from .priors import sample_prior_model, sample_prior_obs

    _, _, unconstrain = _make_objective(setup, use_sprd)
    k_m, k_o, k_s = random.split(random.PRNGKey(seed), 3)
    ms = jax.vmap(sample_prior_model)(random.split(k_m, n))
    os_ = jax.vmap(lambda k: sample_prior_obs(
        k, setup.field_areas, setup.min_field_area,
        getattr(setup, 'obs_model', 'poisson')))(random.split(k_o, n))
    sprds = random.uniform(k_s, (n,), jnp.float32, 1e-3, 1 - 1e-3)
    zs = np.asarray(jax.vmap(unconstrain)(ms, os_, sprds), np.float64)
    return zs.var(axis=0)


def regularize_cov_z(cov_z, prior_var, floor_frac=1e-4):
    """Spectral prior-floor SAFETY NET for a Laplace covariance: each
    eigendirection's variance is floored at ``floor_frac`` × its
    prior-variance projection ``v^T diag(prior_var) v`` (f64 throughout).

    ``floor_frac`` is deliberately tiny (default: sd floor at 1% of the
    prior sd): a genuinely data-informed direction can legitimately sit
    orders of magnitude below prior scale, so a large floor would inflate
    real information; the principled repair of numerically-crushed
    directions is :func:`blend_prior_metric` (likelihood/prior curvature
    decomposition) — this floor only guarantees no direction can ever
    reach f32-epsilon scale again.  Deliberately-pinned slots have
    ``prior_var = 0`` (``prior_var_z``), so their floor is 0 and they stay
    pinned at the PSD jitter."""
    cov = np.asarray(cov_z, np.float64)
    cov = 0.5 * (cov + cov.T)
    lam, V = np.linalg.eigh(cov)
    proj = (V ** 2 * np.asarray(prior_var, np.float64)[:, None]).sum(0)
    lam = np.maximum(np.abs(lam), floor_frac * proj)
    lam = np.maximum(lam, 1e-12)      # PSD jitter for pinned directions
    out = (V * lam) @ V.T
    return 0.5 * (out + out.T)


def blend_prior_metric(H_raw, H_negprior, H_prior_T, prior_var,
                       noise_rel=1e-5, prior_prec_floor=1e-4,
                       lam_pin=1e12):
    """Posterior covariance estimate that BLENDS prior curvature into
    prior-only/near-null eigendirections (VERDICT r3 item 3) — the repair
    for the round-3 frozen-direction pathology (real-Carnarvon fit,
    carn_study/real/summary.json ``frozen_params``), where f32 noise from
    the Hessian's large entries (~1e6) swamped the O(1) prior-only
    curvature of parameters without a data channel and froze them at
    f32-epsilon moves.

    The decomposition (all f64 on host):

    * ``H_lik = H_raw − H_negprior`` — pure likelihood curvature (the
      bijection-Jacobian terms cancel exactly: neither Hessian includes
      them);
    * eigenvalues of ``H_lik`` below ``noise_rel × max|eig|`` (the f32
      noise floor of the device-computed Hessian) or negative are ZEROED —
      a prior-only direction's apparent likelihood curvature is exactly
      such noise;
    * posterior precision ``Λ = H_lik⁺ + H_prior_T`` where ``H_prior_T``
      is the exact prior curvature of the NUTS target (prior + bijection
      log-Jacobian), PSD-clipped to ``[prior_prec_floor, lam_pin]``;
    * pinned slots (``prior_var == 0``: the fixed n_periods packing
      column) get precision ``lam_pin`` outright;
    * covariance = ``Λ⁻¹``.

    A crushed prior-only direction thus recovers its FULL prior scale
    (its posterior ≈ its prior), while a data-informed direction keeps its
    genuine likelihood curvature untouched — the property a uniform
    spectral floor cannot deliver (any floor high enough to rescue the
    former inflates the latter).
    """
    H_lik = (np.asarray(H_raw, np.float64)
             - np.asarray(H_negprior, np.float64))
    H_lik = 0.5 * (H_lik + H_lik.T)
    lam, V = np.linalg.eigh(H_lik)
    tau = noise_rel * np.max(np.abs(lam)) if lam.size else 0.0
    lam = np.where(lam > tau, lam, 0.0)
    H_lik_psd = (V * lam) @ V.T

    Hp = np.asarray(H_prior_T, np.float64)
    Hp = 0.5 * (Hp + Hp.T)
    lp, Vp = np.linalg.eigh(Hp)
    lp = np.clip(np.abs(lp), prior_prec_floor, lam_pin)
    Hp_psd = (Vp * lp) @ Vp.T

    prec = H_lik_psd + Hp_psd
    pinned = np.asarray(prior_var, np.float64) == 0.0
    if pinned.any():
        idx = np.where(pinned)[0]
        prec[idx, :] = 0.0
        prec[:, idx] = 0.0
        prec[idx, idx] = lam_pin
    prec = 0.5 * (prec + prec.T)
    cov = np.linalg.inv(prec)
    return 0.5 * (cov + cov.T)


def _neg_logprior_z(setup: BayesSetup, constrain, with_jacobian):
    """Negative log prior over the unconstrained vector; optionally
    including the bijection log-Jacobian (the prior part of the NUTS
    target, make_transformed_logpdf).  Forward-model-free: cheap to
    autodiff exactly."""
    from .priors import log_prior_model, log_prior_obs
    n_sent = setup.n_sent

    def theta_flat(z):
        m_vec, o_vec, sprd = constrain(z)
        parts = [m_vec, o_vec]
        if sprd is not None:
            parts.append(jnp.reshape(sprd, (1,)))
        return jnp.concatenate(parts)

    def neg_prior(z):
        m_vec, o_vec, _ = constrain(z)
        lp = log_prior_model(_as_model(m_vec)) + log_prior_obs(
            _as_obs(o_vec, n_sent), setup.field_areas,
            setup.min_field_area, getattr(setup, 'obs_model', 'poisson'))
        if not with_jacobian:
            return -lp
        jac = jax.jacfwd(theta_flat)(z)
        d = jnp.max(jnp.abs(jac), axis=1)
        return -lp - jnp.sum(jnp.log(jnp.where(d > 0, d, 1.0)))

    return neg_prior


def laplace_warm_mass(setup: BayesSetup, n_steps=200, use_sprd=False,
                      floor_frac=1e-4):
    """The ``--mass laplace``/``--mass ridge`` warm-start recipe, in one
    place: MAP fit → Laplace Hessian → likelihood/prior curvature blend
    (``blend_prior_metric``: noise-thresholded likelihood spectrum + exact
    prior curvature, so prior-only directions keep full prior scale) →
    tiny spectral safety floor (``regularize_cov_z``) → float32 dense
    inverse mass matrix.  Returns ``(fit, inv_mass)`` with
    ``fit['cov_z_reg']`` holding the regularized f64 covariance (the
    whitening input for ``--mass ridge``).  Shared by ``bayes/run.py``
    and the bench's ``measure_nuts_801`` so the regression-tracked
    configuration IS the production path, not a hand-synced copy."""
    fit = map_fit(setup, n_steps=n_steps, use_sprd=use_sprd)
    lap = laplace_approximation(setup, fit)
    _, constrain, _ = _make_objective(setup, use_sprd)
    z = jnp.asarray(fit['z'], jnp.float32)
    H_negprior = np.asarray(jax.jit(jax.hessian(
        _neg_logprior_z(setup, constrain, with_jacobian=False)))(z))
    H_prior_T = np.asarray(jax.jit(jax.hessian(
        _neg_logprior_z(setup, constrain, with_jacobian=True)))(z))
    pv = prior_var_z(setup, use_sprd=use_sprd)
    cov = blend_prior_metric(lap['hess_z'], H_negprior, H_prior_T, pv)
    cov_reg = regularize_cov_z(cov, pv, floor_frac=floor_frac)
    fit['cov_z_reg'] = cov_reg
    inv0 = np.asarray(cov_reg, np.float32)
    return fit, inv0


def laplace_approximation(setup: BayesSetup, fit):
    """Normal approximation around the MAP point (ref pm.NormApprox,
    Bayes_MAP.py:521-569): returns means and the full covariance in the
    *unconstrained* space plus per-parameter standard deviations mapped
    back through the bijections by linearization."""
    neg_logpost, constrain, _ = _make_objective(setup, fit['use_sprd'])
    z = jnp.asarray(fit['z'])
    H = hessian_columns(neg_logpost, z)
    # np.array (copy): np.asarray of a CPU-backend jax array is a read-only
    # zero-copy view, and the regularization below writes in place
    H = np.array(H)
    H_raw = np.array(H, np.float64)   # pre-surgery copy (blend_prior_metric)
    # free slots: fixed parameters (n_periods) leave an exactly-zero row
    free = np.abs(np.diag(H)) >= 1e-12
    # regularize singular directions (e.g. the fixed n_periods slot)
    for i in range(H.shape[0]):
        if not free[i]:
            H[i, i] = 1e12
    cov_z = np.linalg.inv(H)

    # Laplace marginal likelihood (conditional on the fixed n_periods, like
    # the VI ELBO): logZ ~ logp(theta_hat) + log|J(z_hat)| + (d/2)log(2pi)
    # - (1/2) log det H over the free z block.  Each theta_i is an
    # elementwise bijection of one z_j, so |J| is the product of the
    # per-column row-max magnitudes; including sprd_factor when fit.  A
    # non-PD Hessian (unconverged MAP / saddle) is reported as nan.
    def theta_full(zz):
        m, o, sprd = constrain(zz)
        parts = [m, o]
        if fit['use_sprd']:
            parts.append(jnp.reshape(sprd, (1,)))
        return jnp.concatenate(parts)

    jac_full = np.asarray(jax.jit(jax.jacobian(theta_full))(z))
    # delta method: sd in constrained space (model+obs rows only — the
    # optional sprd row is the last row of the same Jacobian)
    jac = jac_full[:-1] if fit['use_sprd'] else jac_full
    cov_theta = jac @ cov_z @ jac.T
    col = np.max(np.abs(jac_full), axis=0)
    log_jac = float(np.sum(np.log(col[free])))
    sign, logdet_h = np.linalg.slogdet(H[np.ix_(free, free)])
    d_free = int(free.sum())
    log_evidence = (fit['logp'] + log_jac
                    + 0.5 * d_free * np.log(2.0 * np.pi) - 0.5 * logdet_h
                    if sign > 0 else float('nan'))
    return {'cov_z': cov_z, 'cov_theta': cov_theta, 'hess_z': H_raw,
            'sd_theta': np.sqrt(np.clip(np.diag(cov_theta), 0, None)),
            'free': free, 'log_jac': log_jac, 'logdet_h': float(logdet_h),
            'hess_pd': bool(sign > 0),
            'log_evidence': float(log_evidence)}


def map_report(setup: BayesSetup, fit, laplace=None, out=None):
    """Human-readable report like the reference's MAP/NormApprox text output
    (Bayes_MAP.py:494-517,546-565)."""
    lines = ['MAP fit: logp = {:.4f}, AIC = {:.4f}'.format(
        fit['logp'], fit['AIC'])]
    if laplace and 'log_evidence' in laplace:
        lines.append(
            'Laplace log-evidence (n_periods fixed): {:.4f}{}'.format(
                laplace['log_evidence'],
                '' if laplace['hess_pd'] else
                '  [nan: Hessian not positive definite at the fit]'))
    from .priors import obs_extra_names
    names = (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
             + ['sent_obs_prob_{}'.format(k)
                for k in setup.locinfo.sent_ids]
             + list(obs_extra_names(getattr(setup, 'obs_model',
                                            'poisson'))))
    vals = np.concatenate([fit['model'], fit['obs']])
    sds = laplace['sd_theta'] if laplace else None
    for i, (n, v) in enumerate(zip(names, vals)):
        if sds is not None:
            lines.append('  {:>18s} = {:<12.6g} (sd {:.4g})'.format(
                n, v, sds[i]))
        else:
            lines.append('  {:>18s} = {:<12.6g}'.format(n, v))
    if fit['use_sprd']:
        lines.append('  {:>18s} = {:<12.6g}'.format('sprd_factor',
                                                    fit['sprd_factor']))
    text = '\n'.join(lines)
    if out:
        with open(out, 'w') as f:
            f.write(text + '\n')
    return text


def main(argv=None):
    """CLI like the reference ``python Bayes_MAP.py --MAP | --norm``
    (Bayes_MAP.py:572-651): coarser domain (10000 m, 200 cells,
    Bayes_MAP.py:95), n_periods fixed, Kalbar pre-spread factor active."""
    import argparse
    from ..config import Params
    from ..utils.cache import enable_compilation_cache

    parser = argparse.ArgumentParser(prog='parasitoids_tpu.bayes.map_fit')
    g = parser.add_mutually_exclusive_group(required=True)
    g.add_argument('--MAP', action='store_true',
                   help='find the posterior mode')
    g.add_argument('--norm', action='store_true',
                   help='MAP + Laplace normal approximation')
    parser.add_argument('-o', '--outname', default='map_fit.txt')
    parser.add_argument('--steps', type=int, default=300)
    parser.add_argument('--starts', type=int, default=1,
                        help='multi-start global MAP: N Adam runs from '
                             'over-dispersed (prior-drawn) starting points '
                             'sharded over the device mesh; best mode wins')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--polish', type=int, default=0, metavar='N',
                        help='L-BFGS refinement steps after the Adam fit '
                             '(sharper mode for --norm/AIC)')
    parser.add_argument('--shard-forward', action='store_true',
                        help='shard each forward simulation\'s '
                             'flight-minute axis over the device mesh '
                             '(single-fit latency scaling, as on '
                             'bayes.run); incompatible with --starts > 1, '
                             'which shards over starts instead')
    parser.add_argument('overrides', nargs='*')
    args = parser.parse_args(argv)
    if args.shard_forward and args.starts > 1:
        parser.error('--shard-forward is incompatible with --starts > 1 '
                     '(multi-start already shards over the mesh)')
    enable_compilation_cache()

    params = Params()
    params.cmd_line_chg(['--kalbar'])
    params.PLOT = False
    params.OUTPUT = False
    params.PROB_MODEL = False
    params.domain_info = (10000.0, 200)
    for ov in args.overrides:
        if '=' in ov:
            k, _, v = ov.partition('=')
            params.chg_param(k, v)
    setup = BayesSetup(params)
    if args.shard_forward:
        import jax
        if len(jax.devices()) > 1:     # same guard as bayes.run:815-819 —
            from ..parallel.domain import minute_mesh   # a 1-device
            setup = setup.with_forward_mesh(minute_mesh())  # shard_map is
            print('forward pass sharded over {} devices (flight-minute '
                  'axis)'.format(setup.forward_mesh.devices.size))
        else:                          # pure overhead
            print('--shard-forward: single device, running unsharded')

    import time
    tic = time.time()
    if args.starts > 1:
        import jax
        mesh = None
        n_dev = len(jax.devices())
        if n_dev > 1 and args.starts % n_dev == 0:
            from ..parallel.chains import chain_mesh
            mesh = chain_mesh()
            print('starts sharded over {} devices'.format(n_dev))
        fit = map_fit_multistart(setup, n_starts=args.starts,
                                 seed=args.seed, n_steps=args.steps,
                                 mesh=mesh, verbose=True)
        print('multistart: best start {} of {}; per-start logp: {}'.format(
            fit['best_start'], args.starts,
            np.array2string(fit['start_logps'], precision=1)))
    else:
        fit = map_fit(setup, n_steps=args.steps)
    adam_dt = time.time() - tic
    print('optimization: {:.1f} s for {} steps '
          '({:.2f} sec./model eval incl. gradient)'.format(
              adam_dt, args.steps, adam_dt / args.steps))
    if args.polish:
        pre = fit['logp']
        tic = time.time()
        fit = lbfgs_polish(setup, fit['z'], n_steps=args.polish,
                           use_sprd=fit['use_sprd'])
        print('L-BFGS polish: logp {:.4f} -> {:.4f} ({} steps, {:.1f} s; '
              'each step may take several linesearch evals)'.format(
                  pre, fit['logp'], args.polish, time.time() - tic))
    lap = None
    if args.norm:
        tic = time.time()
        lap = laplace_approximation(setup, fit)
        print('laplace: {:.1f} s'.format(time.time() - tic))
    report = map_report(setup, fit, lap, out=args.outname)
    print(report)
    print('written to', args.outname)


if __name__ == '__main__':
    main()

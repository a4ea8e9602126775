"""Automatic-differentiation variational inference (ADVI) over the full
posterior, with PSIS quality diagnostics.

Beyond-reference capability: the reference's fastest approximate-inference
path is PyMC 2's gradient-free ``NormApprox`` (Bayes_MAP.py:521-569 — a
Laplace approximation from finite-difference curvature).  Because this
rebuild's forward model is differentiable end to end, we can instead fit a
Gaussian ``q(z)`` to the *transformed-space* posterior by stochastic
gradient ascent on the evidence lower bound (ADVI, Kucukelbir et al. 2017
JMLR) — mean-field or full-rank — which (unlike Laplace) targets global
posterior mass rather than local curvature at the mode.  This yields:

- a seconds-scale approximate posterior next to the MCMC samplers;
- the ELBO, a lower bound on the model log-evidence — a fourth independent
  estimate next to parallel tempering's thermodynamic-integration /
  stepping-stone (tempering.py) and SMC's annealed-importance telescope
  (smc.py);
- Pareto-smoothed importance sampling on draws from ``q`` (Vehtari et al.
  PSIS; Yao et al. 2018 "Yes, but did it work?"): the tail-shape ``k_hat``
  diagnoses whether q is usable as an IS proposal (k < 0.7), and the
  importance weights give a (consistent, unlike the ELBO) logZ estimate.

Scope note: like NUTS and the reference's own MAP (Bayes_MAP.py:144-147),
the discrete ``n_periods`` parameter is held fixed at 30, so the ELBO / IS
logZ estimate the *conditional* evidence p(data | n_periods=30).  The PT and
SMC estimators marginalize n_periods over its Poisson(30) prior; when the
likelihood varies slowly in n_periods near 30 (it does — the wind-averaging
window changes by minutes) the two normalizations agree to within a couple
of nats.  Cross-run comparisons should keep this in mind.

Execution: the Monte-Carlo ELBO gradient runs the forward model once per MC
draw under ``lax.map`` (never ``vmap`` — a parameter-batched forward pass
pays every rho ``lax.switch`` branch, see parallel/chains.py), and the Adam
loop is dispatched in bounded chunks exactly like map_fit.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax, random

__all__ = ['advi', 'fit_advi', 'q_draws', 'q_logpdf', 'gpd_fit', 'psis',
           'vi_evidence']

_LOG_2PI = float(np.log(2.0 * np.pi))


# ----------------------------------------------------------------------
# Gaussian variational family over the active coordinates
# ----------------------------------------------------------------------

def _unpack_scale(params, da):
    """Return (standard-deviation vector or None, full Cholesky or None)."""
    if 'offdiag' in params:
        L = jnp.zeros((da, da))
        if da > 1:
            L = L.at[jnp.tril_indices(da, -1)].set(params['offdiag'])
        L = L + jnp.diag(jnp.exp(params['log_diag']))
        return None, L
    return jnp.exp(params['log_diag']), None


def _q_sample_active(params, eps):
    """One draw of the active block from q given standard-normal eps."""
    da = eps.shape[-1]
    sd, L = _unpack_scale(params, da)
    if L is None:
        return params['mu'] + sd * eps
    return params['mu'] + L @ eps


def _q_entropy(params, da):
    """Differential entropy of q (analytic — the ADVI entropy term)."""
    return 0.5 * da * (_LOG_2PI + 1.0) + jnp.sum(params['log_diag'])


def _q_logpdf_active(params, z_active):
    da = z_active.shape[-1]
    sd, L = _unpack_scale(params, da)
    diff = z_active - params['mu']
    if L is None:
        quad = jnp.sum((diff / sd) ** 2)
    else:
        y = jax.scipy.linalg.solve_triangular(L, diff, lower=True)
        quad = jnp.sum(y ** 2)
    return -0.5 * (quad + da * _LOG_2PI) - jnp.sum(params['log_diag'])


def _embed(z0, idx, z_active):
    return z0.at[idx].set(z_active)


# ----------------------------------------------------------------------
# core optimizer (generic over any logpdf)
# ----------------------------------------------------------------------

def advi(logpdf, z0, key, active=None, n_steps=600, n_mc=4,
         learning_rate=0.02, fullrank=False, chunk_steps=25,
         init_log_sigma=-2.0, mu0=None, verbose=False):
    """Fit a Gaussian q to ``exp(logpdf)`` (unnormalized) over the
    coordinates marked ``active`` (inactive ones stay pinned at ``z0``,
    e.g. the fixed n_periods slot).  Returns a plain dict (npz-storable).
    """
    z0 = jnp.asarray(z0, jnp.float32)
    d = z0.shape[0]
    if active is None:
        active = np.ones(d, bool)
    idx = jnp.asarray(np.nonzero(np.asarray(active))[0])
    da = int(idx.shape[0])

    params = {'mu': (jnp.asarray(mu0, jnp.float32)[idx] if mu0 is not None
                     else z0[idx]),
              'log_diag': jnp.full((da,), init_log_sigma, jnp.float32)}
    if fullrank:
        params['offdiag'] = jnp.zeros((da * (da - 1) // 2,), jnp.float32)

    def neg_elbo(params, key):
        eps = random.normal(key, (n_mc, da))
        # one forward-model evaluation per MC draw, sequential on device
        vals = lax.map(
            lambda e: logpdf(_embed(z0, idx, _q_sample_active(params, e))),
            eps)
        return -(jnp.mean(vals) + _q_entropy(params, da))

    opt = optax.adam(learning_rate)

    @partial(jax.jit, static_argnames='length')
    def run_chunk(params, opt_state, key, length):
        def step(carry, _):
            params, opt_state, key = carry
            key, sub = random.split(key)
            loss, grad = jax.value_and_grad(neg_elbo)(params, sub)
            grad = jax.tree.map(
                lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grad)
            updates, opt_state = opt.update(grad, opt_state)
            return (optax.apply_updates(params, updates), opt_state,
                    key), loss

        (params, opt_state, key), losses = lax.scan(
            step, (params, opt_state, key), None, length=length)
        return params, opt_state, key, losses

    opt_state = opt.init(params)
    losses = []
    done = 0
    while done < n_steps:
        length = min(chunk_steps, n_steps - done)
        # block per chunk (queue depth, see map_fit.py)
        params, opt_state, key, chunk_losses = jax.block_until_ready(
            run_chunk(params, opt_state, key, length))
        losses.append(np.asarray(chunk_losses))
        done += length
        if verbose:
            print('  ADVI step {:4d}/{}: ELBO estimate {:.2f}'.format(
                done, n_steps, -float(losses[-1][-1])), flush=True)
    elbo_trace = (-np.concatenate(losses) if losses else np.zeros(0))

    res = {'mu': np.asarray(params['mu']),
           'log_diag': np.asarray(params['log_diag']),
           'idx': np.asarray(idx), 'z0': np.asarray(z0),
           'fullrank': fullrank, 'elbo_trace': elbo_trace}
    if fullrank:
        res['offdiag'] = np.asarray(params['offdiag'])
    return res


def _res_params(res):
    params = {'mu': jnp.asarray(res['mu']),
              'log_diag': jnp.asarray(res['log_diag'])}
    if res.get('fullrank') and 'offdiag' in res:
        params['offdiag'] = jnp.asarray(res['offdiag'])
    return params


def q_draws(res, key, n):
    """n draws of the full z vector from the fitted q."""
    params = _res_params(res)
    idx = jnp.asarray(res['idx'])
    z0 = jnp.asarray(res['z0'])
    da = int(idx.shape[0])
    eps = random.normal(key, (n, da))
    return jax.vmap(
        lambda e: _embed(z0, idx, _q_sample_active(params, e)))(eps)


def q_logpdf(res, z):
    """log q(z) over the active block (inactive coordinates are a shared
    point mass, which cancels in importance ratios)."""
    params = _res_params(res)
    idx = jnp.asarray(res['idx'])
    return _q_logpdf_active(params, jnp.asarray(z)[idx])


# ----------------------------------------------------------------------
# PSIS: generalized-Pareto tail fit + smoothed importance weights
# ----------------------------------------------------------------------

def gpd_fit(x):
    """Zhang & Stephens (2009) posterior-mean fit of the generalized Pareto
    shape k and scale sigma to exceedances ``x`` (ascending, > 0).  Host
    NumPy f64 — this is sample-size-bounded post-processing."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    m_est = 30 + int(np.sqrt(n))
    j = np.arange(1, m_est + 1)
    b = 1.0 - np.sqrt(m_est / (j - 0.5))
    b = b / (3.0 * x[max(int(n / 4 + 0.5) - 1, 0)]) + 1.0 / x[-1]
    k_b = np.mean(np.log1p(-b[:, None] * x), axis=1)
    with np.errstate(divide='ignore', invalid='ignore'):
        prof = n * (np.log(-b / k_b) - k_b - 1.0)
    prof = np.where(np.isfinite(prof), prof, -np.inf)
    w = np.exp(prof - prof.max())          # stable softmax weights
    w = w / w.sum()
    b_post = np.sum(b * w)
    k_post = np.mean(np.log1p(-b_post * x))
    # sigma from the RAW shape: k and b always carry opposite signs, so
    # -k/b > 0; regularizing first can flip k's sign and yield a negative
    # scale (NaN quantiles downstream in ``psis``)
    sigma = -k_post / b_post
    # weakly-informative shape regularization (Vehtari et al., PSIS paper)
    k_post = (n * k_post + 5.0) / (n + 10.0)
    return k_post, sigma


def psis(logw):
    """Pareto-smoothed importance weights: fit a GPD to the largest
    ``M = min(0.2 n, 3 sqrt(n))`` raw weights and replace them by the
    expected order statistics of the fitted tail.  Returns (smoothed logw,
    k_hat)."""
    logw = np.asarray(logw, np.float64)
    n = logw.shape[0]
    M = int(min(np.ceil(0.2 * n), np.ceil(3.0 * np.sqrt(n))))
    if M < 5 or n < 16:
        return logw.copy(), np.inf
    order = np.argsort(logw)
    shift = logw.max()                     # overflow guard
    w = np.exp(logw - shift)
    cutoff = w[order[-M - 1]]
    # strict exceedances only (arviz semantics): weight ties at the cutoff
    # — ubiquitous in Metropolis chains with repeated states — would
    # otherwise enter the GPD fit as ~0 exceedances and skew it
    tail_idx = order[-M:][w[order[-M:]] > cutoff]
    m_t = tail_idx.shape[0]
    if m_t < 5:
        return logw.copy(), np.inf
    khat, sigma = gpd_fit(np.sort(w[tail_idx] - cutoff))
    if np.isfinite(khat) and sigma > 0:
        # inverse-CDF of the fitted GPD at the expected quantiles
        p = (np.arange(1, m_t + 1) - 0.5) / m_t
        if abs(khat) < 1e-12:
            q = -sigma * np.log1p(-p)
        else:
            q = sigma * np.expm1(-khat * np.log1p(-p)) / khat
        # tail_idx is ascending in logw, and q is ascending in p, so the
        # fitted order statistics map onto the raw tail positionally; cap
        # at the raw maximum (Vehtari et al. recommendation)
        smoothed = np.minimum(np.log(cutoff + q) + shift, shift)
        out = logw.copy()
        out[tail_idx] = smoothed
        return out, khat
    return logw.copy(), np.inf


# ----------------------------------------------------------------------
# model-level wrappers
# ----------------------------------------------------------------------

_N_PERIODS_SLOT = 13    # fixed discrete slot, see map_fit._make_objective


def _model_logpdf(setup, use_sprd=None):
    from .nuts import make_transformed_logpdf
    if use_sprd is None:
        use_sprd = False    # match Bayes_Run (sprd disabled, Run.py:168-175)
    logpdf, constrain, z0 = make_transformed_logpdf(setup, use_sprd)
    active = np.ones(int(z0.shape[0]), bool)
    active[_N_PERIODS_SLOT] = False
    return logpdf, constrain, z0, active


def fit_advi(setup, key, n_steps=600, n_mc=4, learning_rate=0.02,
             fullrank=False, use_sprd=None, init='map', init_map_steps=200,
             chunk_steps=25, verbose=False):
    """ADVI over the full parasitoid posterior.  ``init='map'`` (default)
    starts the variational mean at a short MAP fit — the prior point
    predicts ~zero density at most observed cells, where floor-rate
    log-likelihood terms drown the ELBO gradient in f32 noise (same
    rationale as the NUTS initialization, run.py)."""
    if use_sprd is None:
        use_sprd = False    # match Bayes_Run (sprd disabled, Run.py:168-175)
    logpdf, constrain, z0, active = _model_logpdf(setup, use_sprd)
    mu0 = None
    if init == 'map':
        from .map_fit import map_fit
        if verbose:
            print('ADVI init: MAP fit ({} steps)...'.format(init_map_steps),
                  flush=True)
        # use_sprd must match _model_logpdf's: the sprd slot changes the
        # z-vector length, and a shorter MAP z would silently clamp-gather
        # into the wrong variational mean coordinate
        fit = map_fit(setup, n_steps=init_map_steps, use_sprd=use_sprd)
        if verbose:
            print('ADVI init: MAP logp = {:.2f}'.format(fit['logp']),
                  flush=True)
        mu0 = fit['z']
    res = advi(logpdf, z0, key, active=active, n_steps=n_steps, n_mc=n_mc,
               learning_rate=learning_rate, fullrank=fullrank,
               chunk_steps=chunk_steps, mu0=mu0, verbose=verbose)
    res['use_sprd'] = bool(use_sprd)
    return res


def vi_evidence(setup, res, key, n=256, use_sprd=None):
    """Importance-sampling evidence check of a fitted q: draws n samples,
    evaluates ``logw = logpost(z) - logq(z)``, and returns the ELBO
    (re-estimated on these draws), the IS logZ ``logsumexp(logw) - log n``,
    and the PSIS tail diagnostic ``k_hat`` (q trustworthy for IS when
    k_hat < 0.7).  Also returns per-draw constrained log posteriors for
    trace storage."""
    logpdf, constrain, z0, active = _model_logpdf(
        setup, res.get('use_sprd', False) if use_sprd is None else use_sprd)
    zs = q_draws(res, key, n)
    logq = jax.vmap(lambda z: q_logpdf(res, z))(zs)
    # sequential forward evals (lax.map; see module docstring)
    logp = lax.map(logpdf, zs)
    logw = np.asarray(logp, np.float64) - np.asarray(logq, np.float64)
    logw_s, khat = psis(logw)
    n_f = float(n)
    logz_is = float(
        np.log(np.sum(np.exp(logw_s - logw_s.max()))) + logw_s.max()
        - np.log(n_f))
    # constrained-space log posterior per draw (for trace storage): the
    # Jacobian is elementwise-bijection-cheap, no forward model involved
    jac = jax.vmap(jax.jit(logpdf.log_jacobian))(zs)
    logpost = np.asarray(logp, np.float64) - np.asarray(jac, np.float64)
    return {'elbo': float(np.mean(logw)), 'logz_is': logz_is,
            'khat': float(khat), 'logw': logw, 'zs': np.asarray(zs),
            'logpost': logpost}

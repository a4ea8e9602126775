"""Simulation-based calibration of the full inference stack.

Beyond-reference capability: the reference has no way to test that its
sampler actually samples the posterior it writes down — PyMC 2's machinery
is trusted blind.  SBC (Talts, Betancourt, Simpson, Vehtari & Gelman 2018,
arXiv:1804.06788) closes the loop using machinery this rebuild already
has: the exact prior samplers (priors.py), the synthetic-data generator
(predictive.simulate_observations — the same thinned-Poisson observation
model the likelihood evaluates), and cheap replicate construction: each
replicate's dataset enters as a traced operand (``BayesSetup.obs_pytree``
+ ``run_mcmc(..., obs=...)`` for AM; ``make_transformed_logpdf(
traced_obs=True)`` + ``nuts_sample(..., logpdf_args=(obs,))`` for NUTS),
so all replicates share ONE compiled program per sampler
(``with_observations`` would bake each dataset in as HLO constants —
a full XLA recompile per replicate, ~40 s each at full config).

Per replicate: draw truth ``theta* ~ prior``, simulate a dataset
``y ~ p(y | theta*)``, run the sampler on ``y``, and record the rank of
``theta*`` among ``L`` thinned posterior draws, per parameter.  If the
sampler is exact, ranks are uniform on {0..L} — *any* systematic bias
(wrong prior, likelihood mismatch, broken adaptation, resume bugs) shows
up as U-shaped, peaked, or skewed rank histograms.  ``sbc_uniformity``
reduces each parameter's histogram to a chi-square p-value.

This validates the *whole* chain end to end — priors, forward model,
observation model, sampler, trace handling — against itself, which is the
strongest internal check an inference code can run.

CLI::

    python -m parasitoids_tpu.bayes.sbc --replicates 20 --samples 400 \
        --burn 200 [key=value overrides]

writes ``sbc_ranks.npz`` + ``sbc.png`` and prints per-parameter p-values.
Replicates run sequentially (each is a fresh dataset); chain-level device
parallelism inside a replicate follows the normal sampler paths.
"""

from __future__ import annotations

import os

import numpy as np

from .model import BayesSetup
from .priors import MODEL_PARAM_NAMES, OBS_PARAM_NAMES

__all__ = ['run_sbc', 'sbc_uniformity', 'plot_sbc', 'main']


def _param_names(setup):
    from .priors import obs_extra_names
    return (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
            + ['sent_obs_prob_{}'.format(k)
               for k in setup.locinfo.sent_ids]
            + list(obs_extra_names(getattr(setup, 'obs_model',
                                           'poisson'))))


def run_sbc(setup: BayesSetup, n_replicates, key, n_samples=200, burn=100,
            thin=5, seed=0, verbose=False, sampler='am', max_depth=6,
            stepwise=False, steps_per_call=25, obs_sweeps=1, chains=1,
            checkpoint_path=None, warm_start=False, ridge=False):
    """SBC rank statistics for a sampler (``'am'`` or ``'nuts'``).

    Returns ``{'ranks': (R, dim) int array, 'L': draws per replicate,
    'names': parameter names, 'truths': (R, dim)}``.  Chains are
    initialized at the replicate's own truth — SBC permits any
    initialization, and starting in the typical set keeps the required
    burn-in honest for short validation chains.

    ``chains``: AM only — pool each replicate's L rank draws from this
    many independent chains ((burn + n_samples) steps each, same truth
    init, different keys).  A single short random-walk chain's thinned
    draws sit on ONE excursion, so when a parameter's autocorrelation
    time approaches the window the truth's rank piles at the edges even
    for an exact sampler (the finite-chain artifact of Talts et al.
    §5.1); pooling independent excursions attacks exactly that failure
    mode at the same cost per kept draw.

    ``checkpoint_path``: persist (ranks, truths, completed count) after
    every replicate and resume from it on restart.  Replicate ``r``'s RNG
    derives only from (key, seed, r) — ``fold_in(key, r)`` and
    ``default_rng([seed, r])`` — so a resumed study is bit-identical to
    an uninterrupted one.  Long arms (NUTS is ~8 min/replicate at the
    study config) survive bounded-session kills this way.

    ``sampler='nuts'`` validates the gradient path: the NUTS target holds
    the discrete ``n_periods`` fixed at 30 (like the reference's MAP), so
    the replicate truths are drawn from the prior CONDITIONED on
    ``n_periods = 30`` and the ranks test that conditional posterior —
    a coherent SBC of exactly the model NUTS samples.  ``stepwise=True``
    dispatches each NUTS transition as its own bounded device program
    (:func:`nuts_sample_stepwise`).

    ``warm_start`` (NUTS only): precondition each replicate's chain with a
    dense mass matrix from the Hessian of its own log posterior at the
    replicate truth (``inv_mass_from_hessian``; the truth sits in the
    typical set of its own posterior, so the local curvature is the right
    metric), and keep it FIXED — warmup then only adapts the step size, so
    ``burn`` can drop to ~50 transitions and the preconditioned
    trajectories U-turn at much shallower tree depth.  This changes the
    adaptation schedule, never the invariant distribution: every post-
    warmup draw still comes from an exact NUTS kernel on the same target,
    so the SBC null (uniform ranks) is unchanged.

    ``ridge`` (NUTS only; VERDICT r4 item 3): the controlled experiment
    the warm arm's χ² attribution demanded.  Instead of a FIXED
    Hessian-at-truth metric, each replicate gets the production ``--mass
    ridge`` recipe anchored at its own truth: truth-Hessian →
    ``blend_prior_metric`` (noise-thresholded likelihood curvature +
    exact prior curvature) → ``regularize_cov_z`` → ``whiten_transform``,
    and NUTS samples the whitened u-target from an identity metric with
    dense Welford adaptation ON — the exact machinery that repaired the
    801² ridge mixing (ESS/draw 0.02 → ~0.3, runs/nuts_r4_summary.json).
    If the warm arm's 5/25 χ² flags were the finite-window slow-ridge
    artifact, this arm's flags go to ≈0; if they persist, the defect is
    real.
    The whitening map enters the NUTS target as TRACED operands
    (L, center, anchor alongside the replicate dataset), so all
    replicates still share ONE compiled program.
    """
    import jax
    import jax.numpy as jnp
    from jax import random

    from .predictive import simulate_observations
    from .priors import sample_prior_model, sample_prior_obs
    from .sampler import MCMCConfig, init_chain_state, run_mcmc

    if sampler == 'nuts':
        from .map_fit import _make_objective
        from .nuts import (NUTSConfig, inv_mass_from_hessian,
                           make_transformed_logpdf, nuts_sample,
                           nuts_sample_stepwise)

        # one target for every replicate — datasets enter as traced
        # operands below, so the static (logpdf, config) jit key is
        # constant and all replicates share ONE compiled program
        logpdf, constrain, _ = make_transformed_logpdf(
            setup, traced_obs=True)
        _, _, unconstrain = _make_objective(setup, False)
        hess_fn = None
        if warm_start or ridge:
            # batched jax.hessian pushes all d JVP columns through the
            # forward graph at once — fine at the SBC study's 201² config,
            # but ≥ 401² it asked for 19.7-23.8 GB
            # (map_fit.hessian_columns): switch to sequential HVPs there
            sequential = setup.params.domain_info[1] > 100

            @jax.jit
            def hess_fn(z, obs):
                def nlp(zz):
                    return -logpdf(zz, obs)
                if sequential:
                    hvp = lambda v: jax.jvp(jax.grad(nlp), (z,), (v,))[1]
                    H = jax.lax.map(hvp, jnp.eye(z.shape[0],
                                                 dtype=z.dtype))
                else:
                    H = jax.hessian(nlp)(z)
                if ridge:
                    return H            # raw curvature: the blend's input
                return inv_mass_from_hessian(H)
        if ridge:
            # ridge whitening per replicate, shared compiled programs:
            # prior-curvature Hessians (forward-model-free, cheap) + MC
            # prior variances once, the blend/eigen work on host f64, and
            # the u-space target takes (obs, L, center, anchor) as TRACED
            # operands so the replicate loop never retraces NUTS
            from .map_fit import (_make_objective as _mo, _neg_logprior_z,
                                  blend_prior_metric, prior_var_z,
                                  regularize_cov_z)
            from .nuts import whiten_transform
            _, constrain_z, _ = _mo(setup, False)
            _hess_negprior = jax.jit(jax.hessian(_neg_logprior_z(
                setup, constrain_z, with_jacobian=False)))
            _hess_prior_T = jax.jit(jax.hessian(_neg_logprior_z(
                setup, constrain_z, with_jacobian=True)))
            _pv = prior_var_z(setup)

            def ridge_map(z_true, obs_r):
                H_raw = np.asarray(hess_fn(z_true, obs_r), np.float64)
                Hn = np.asarray(_hess_negprior(z_true), np.float64)
                Hp = np.asarray(_hess_prior_T(z_true), np.float64)
                cov = blend_prior_metric(H_raw, Hn, Hp, _pv)
                cov_reg = regularize_cov_z(cov, _pv)
                _, _, L, anchor = whiten_transform(cov_reg,
                                                   np.asarray(z_true,
                                                              np.float64))
                return (jnp.asarray(L, jnp.float32),
                        jnp.asarray(np.asarray(z_true, np.float32)),
                        jnp.asarray(anchor, jnp.float32))

            def logpdf_u(u, obs, L, center, anchor):
                return (logpdf(center + L @ u, obs)
                        - 0.5 * jnp.sum(anchor * u * u))

    dim = 15 + 4 + setup.n_sent + getattr(setup, 'n_extra_obs', 0)
    ranks = np.zeros((n_replicates, dim), np.int64)
    truths = np.zeros((n_replicates, dim))
    L = len(range(burn, burn + n_samples, thin))
    if sampler != 'nuts':
        L = L * int(chains)
    cfg = MCMCConfig(n_samples=burn + n_samples, obs_sweeps=obs_sweeps)
    start = 0
    # the .ckpt.npz is transient (gitignored, lost on a VM recycle); a
    # durable twin with identical payload lives beside it under a
    # non-ignored name so committed partial progress survives restarts
    durable_path = None
    if checkpoint_path:
        durable_path = (checkpoint_path[:-len('.ckpt.npz')] + '_partial.npz'
                        if checkpoint_path.endswith('.ckpt.npz')
                        else checkpoint_path + '.partial.npz')
    # consult BOTH candidates before concluding anything (they are written
    # together, but a crash can leave them out of step): resume from the
    # matching one with the most completed replicates, and only report a
    # fresh start after every existing candidate has failed the config
    # check
    existing, best = 0, None
    for cand in (checkpoint_path, durable_path):
        if not (cand and os.path.exists(cand)):
            continue
        existing += 1
        with np.load(cand) as d:
            old_warm = int(d['warm']) if 'warm' in d.files else 0
            old_ridge = int(d['ridge']) if 'ridge' in d.files else 0
            if (int(d['L']) == L and d['ranks'].shape[1] == dim
                    and int(d['seed']) == seed
                    and str(d['sampler']) == sampler
                    and old_warm == int(bool(warm_start))
                    and old_ridge == int(bool(ridge))):
                done = min(int(d['done']), n_replicates)
                if done > start:
                    start, best = done, cand
                    ranks[:start] = d['ranks'][:start]
                    truths[:start] = d['truths'][:start]
    if verbose and start:
        print('  SBC resume: {} replicate(s) from {}'.format(start, best),
              flush=True)
    elif verbose and existing:
        print('  SBC checkpoint(s) mismatch this config; starting fresh',
              flush=True)
    for r in range(start, n_replicates):
        k_r = random.fold_in(key, r)
        k_m, k_o, k_chain = random.split(k_r, 3)
        m_star = np.array(sample_prior_model(k_m))   # writable host copy
        if sampler == 'nuts':
            m_star[13] = 30.0           # condition on the NUTS target
        o_star = np.asarray(sample_prior_obs(
            k_o, setup.field_areas, setup.min_field_area,
            getattr(setup, 'obs_model', 'poisson')))
        rng = np.random.default_rng([seed, r])
        y = simulate_observations(setup, m_star, o_star, rng)
        if sampler == 'nuts':
            obs_r = setup.obs_pytree(y)
            z_true = unconstrain(jnp.asarray(m_star, jnp.float32),
                                 jnp.asarray(o_star, jnp.float32),
                                 jnp.float32(0.3))
            ncfg = NUTSConfig(num_warmup=burn, num_samples=n_samples,
                              max_depth=max_depth,
                              dense_mass=bool(warm_start or ridge),
                              fixed_mass=bool(warm_start and not ridge))
            if ridge:
                # per-replicate ridge whitening anchored at the truth;
                # NUTS starts at u = 0 (the truth) with an identity
                # metric and Welford dense adaptation ON
                Lw, cw, aw = ridge_map(jnp.asarray(z_true), obs_r)
                u0 = jnp.zeros_like(z_true)
                if stepwise:
                    out = nuts_sample_stepwise(
                        logpdf_u, u0[None], random.split(k_chain, 1),
                        ncfg, logpdf_args=(obs_r, Lw, cw, aw),
                        steps_per_call=steps_per_call)
                    udraws, logp = out['samples'][0], out['logp'][0]
                else:
                    out = jax.block_until_ready(nuts_sample(
                        logpdf_u, u0, k_chain, ncfg,
                        logpdf_args=(obs_r, Lw, cw, aw)))
                    udraws, logp = out['samples'], out['logp']
                zdraws = (np.asarray(udraws, np.float64)
                          @ np.asarray(Lw, np.float64).T
                          + np.asarray(cw, np.float64)).astype(np.float32)
            else:
                im = None
                if warm_start:
                    im = jax.block_until_ready(
                        hess_fn(jnp.asarray(z_true), obs_r))
                if stepwise:
                    out = nuts_sample_stepwise(
                        logpdf, z_true[None], random.split(k_chain, 1),
                        ncfg, logpdf_args=(obs_r,),
                        steps_per_call=steps_per_call,
                        init_inv_mass=None if im is None else im[None])
                    zdraws, logp = out['samples'][0], out['logp'][0]
                else:
                    out = jax.block_until_ready(nuts_sample(
                        logpdf, z_true, k_chain, ncfg,
                        logpdf_args=(obs_r,), init_inv_mass=im))
                    zdraws, logp = out['samples'], out['logp']
            theta = jax.vmap(
                lambda zz: jnp.concatenate(constrain(zz)[:2]))(
                    jnp.asarray(zdraws))
            draws = np.asarray(theta)[::thin][:L]
            metric = 'logp[-1] {:.1f}'.format(float(logp[-1]))
        else:
            # traced-obs path: every replicate's dataset goes through ONE
            # compiled program (with_observations would bake each dataset
            # in as HLO constants — a full XLA recompile per replicate,
            # ~40 s each at full config)
            obs_r = setup.obs_pytree(y)
            parts = []
            for j in range(int(chains)):
                state = init_chain_state(setup, random.fold_in(k_chain, j),
                                         m0=m_star, o0=o_star, obs=obs_r)
                _, trace = jax.block_until_ready(
                    run_mcmc(setup, state, cfg, obs=obs_r))
                parts.append(
                    np.asarray(trace)[burn:burn + n_samples:thin, :dim])
            draws = np.concatenate(parts, axis=0)
            metric = 'loglik* {:.1f}'.format(float(state.loglik))
        truth = np.concatenate([m_star, o_star])
        truths[r] = truth
        # rank with randomized tie-breaking (exact for the discrete
        # n_periods component, a no-op for continuous ones)
        less = (draws < truth).sum(axis=0)
        ties = (draws == truth).sum(axis=0)
        ranks[r] = less + rng.integers(0, ties + 1)
        if verbose:
            print('  SBC replicate {}/{}: {}, ranks '
                  '[{} .. {}] of {}'.format(
                      r + 1, n_replicates, metric,
                      ranks[r].min(), ranks[r].max(), L), flush=True)
        if checkpoint_path:
            payload = dict(ranks=ranks, truths=truths, done=r + 1, L=L,
                           seed=seed, sampler=sampler,
                           warm=int(bool(warm_start)),
                           ridge=int(bool(ridge)),
                           names=np.asarray(_param_names(setup)))
            for dest in (checkpoint_path, durable_path):
                tmp = dest + '.tmp.npz'
                np.savez(tmp, **payload)
                os.replace(tmp, dest)
            # library-level durability (utils/durable.py, VERDICT r3
            # item 7): commit the durable twin as each replicate lands —
            # a VM recycle then costs at most the in-flight replicate
            # (round 3 lost ~19 replicates from script-level-only commits)
            from ..utils.durable import commit_artifacts
            commit_artifacts([durable_path],
                             'SBC durable partial: {} replicates ({})'
                             .format(r + 1, sampler))
    return {'ranks': ranks, 'L': L, 'names': _param_names(setup),
            'truths': truths, 'resumed_at': start}


def sbc_uniformity(ranks, L, n_bins=None):
    """Chi-square uniformity p-value per parameter over binned ranks.

    Under a correct sampler each rank is uniform on {0..L}; small p-values
    across many parameters indicate mis-calibration.  (With few replicates
    the test has little power — it is a smoke alarm, not a certificate.)
    """
    from scipy import stats

    ranks = np.asarray(ranks)
    R, dim = ranks.shape
    if n_bins is None:
        n_bins = max(2, min(L + 1, R // 5, 20))
    edges = np.linspace(0, L + 1, n_bins + 1)
    pvals = np.empty(dim)
    for j in range(dim):
        counts, _ = np.histogram(ranks[:, j], bins=edges)
        pvals[j] = stats.chisquare(counts).pvalue
    return pvals


def sbc_ecdf_pvals(ranks, L, seed=0):
    """Kolmogorov–Smirnov uniformity p-value per parameter via the
    randomized PIT: under H0 the rank r is uniform on {0..L}, so
    (r + u)/(L + 1) with u ~ U(0,1) is exactly Uniform(0,1) — the KS test
    then applies without discreteness corrections.  Complements the
    binned chi-square (``sbc_uniformity``): KS is sensitive to ECDF-scale
    drift (skew/shift), chi-square to local bin anomalies."""
    from scipy import stats

    ranks = np.asarray(ranks)
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=ranks.shape)
    pit = (ranks + u) / (L + 1)
    return np.array([stats.kstest(pit[:, j], 'uniform').pvalue
                     for j in range(ranks.shape[1])])


def plot_sbc(out, outfile, n_bins=None):
    """Rank-histogram grid with the uniform band."""
    import os

    import matplotlib
    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    ranks, L, names = out['ranks'], out['L'], out['names']
    R, dim = ranks.shape
    if n_bins is None:
        n_bins = max(2, min(L + 1, R // 5, 20))
    ncol = 5
    nrow = -(-dim // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 2.2 * nrow),
                             squeeze=False)
    edges = np.linspace(0, L + 1, n_bins + 1)
    expect = R / n_bins
    band = 2 * np.sqrt(expect)
    for j in range(nrow * ncol):
        ax = axes[j // ncol][j % ncol]
        if j >= dim:
            ax.axis('off')
            continue
        ax.hist(ranks[:, j], bins=edges)
        ax.axhspan(expect - band, expect + band, alpha=0.2, color='gray')
        ax.axhline(expect, color='gray', lw=1)
        ax.set_title(names[j], fontsize=9)
        ax.set_yticks([])
    fig.suptitle('SBC rank histograms ({} replicates, {} draws each); '
                 'gray = uniform +/- 2sd'.format(R, L))
    fig.tight_layout()
    fig.savefig(outfile, dpi=130)
    plt.close(fig)
    return outfile


def main(argv=None):
    import argparse
    import time

    from jax import random

    from ..utils.cache import enable_compilation_cache
    from .run import build_setup

    ap = argparse.ArgumentParser(prog='parasitoids_tpu.bayes.sbc')
    ap.add_argument('--replicates', type=int, default=20)
    ap.add_argument('--samples', type=int, default=400)
    ap.add_argument('--burn', type=int, default=200)
    ap.add_argument('--thin', type=int, default=5)
    ap.add_argument('--obs-sweeps', type=int, default=1,
                    help='AM: obs-block Gibbs sweeps per model step '
                         '(cheap; shortens the xi x obs-prob ridge '
                         'autocorrelation that otherwise shows up as '
                         'U-shaped finite-chain rank histograms)')
    ap.add_argument('--chains', type=int, default=1,
                    help='AM: pool each replicate\'s ranks from this many '
                         'independent chains (breaks the single-excursion '
                         'edge-piling of short windows)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--sampler', choices=['am', 'nuts'], default='am',
                    help='which sampler to calibrate; nuts validates the '
                         'gradient path against the prior conditioned on '
                         'n_periods = 30 (the NUTS target)')
    ap.add_argument('--max-depth', type=int, default=6)
    ap.add_argument('--stepwise', action='store_true',
                    help='dispatch NUTS transitions as bounded device '
                         'programs')
    ap.add_argument('--steps-per-call', type=int, default=25,
                    help='stepwise NUTS: transitions per device program')
    ap.add_argument('--warm-start', action='store_true',
                    help='NUTS: fixed dense mass matrix from the Hessian '
                         'at each replicate truth (warmup = step size '
                         'only; same posterior, far fewer gradient evals '
                         '— pair with a short --burn ~50)')
    ap.add_argument('--ridge', action='store_true',
                    help='NUTS: per-replicate ridge whitening at the '
                         'truth (blend_prior_metric + whiten_transform) '
                         'with dense Welford adaptation ON — the '
                         'controlled experiment for the warm arm\'s '
                         'slow-ridge chi2 flags (VERDICT r4 item 3)')
    ap.add_argument('-o', '--outname', default='sbc')
    ap.add_argument('overrides', nargs='*')
    args = ap.parse_args(argv)
    enable_compilation_cache()

    # the canonical Bayes setup — same builder as every other inference CLI,
    # so the calibration target cannot drift from the sampler it validates
    setup = build_setup(args.overrides)

    print('SBC: {} replicates x ({} burn + {} samples, thin {})...'.format(
        args.replicates, args.burn, args.samples, args.thin))
    tic = time.time()
    out = run_sbc(setup, args.replicates, random.PRNGKey(args.seed),
                  n_samples=args.samples, burn=args.burn, thin=args.thin,
                  seed=args.seed, verbose=True, sampler=args.sampler,
                  max_depth=args.max_depth, stepwise=args.stepwise,
                  steps_per_call=args.steps_per_call,
                  obs_sweeps=args.obs_sweeps, chains=args.chains,
                  warm_start=args.warm_start, ridge=args.ridge)
    print('SBC finished: {:.1f} s'.format(time.time() - tic))
    pvals = sbc_uniformity(out['ranks'], out['L'])
    ks = sbc_ecdf_pvals(out['ranks'], out['L'], seed=args.seed)
    for n, p, pk in zip(out['names'], pvals, ks):
        flag = '  <-- check' if min(p, pk) < 0.01 else ''
        print('  {:>18s}: chi2 p = {:.3f}  KS p = {:.3f}{}'.format(
            n, p, pk, flag))
    np.savez(args.outname + '_ranks',
             ranks=out['ranks'], L=out['L'], truths=out['truths'],
             names=np.asarray(out['names']))
    print('wrote {}_ranks.npz'.format(args.outname))
    print('wrote', plot_sbc(out, args.outname + '.png'))


if __name__ == '__main__':
    main()

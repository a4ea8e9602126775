"""Recorded Carnarvon fit: MAP -> AM -> NUTS -> diagnostics (VERDICT r1
item 5 "Done" criterion).

Runs the full inference stack on the carnarvon site (r_dur=5 cohort
likelihood; observations simulated from the documented truth in
data/carnarvon_truth.json) and writes ``carn_study/``:

* ``map.json`` — MAP estimate + logp
* ``am.npz`` / ``nuts.npz`` — posterior traces (store format)
* ``summary.json`` — posterior mean/sd vs truth per parameter, R-hat,
  ESS, truth z-scores (|mean - truth| / sd), wall times

Usage: python scripts/run_carnarvon_fit.py [--am-samples 4000]
       [--nuts-samples 150] [--domain '(10000.0,200)']
(Run it on a GPU: at this size the CPU takes hours.)
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--am-samples', type=int, default=4000)
    ap.add_argument('--am-burn', type=int, default=1000)
    ap.add_argument('--am-chunk', type=int, default=500,
                    help='AM steps per device program (a checkpoint '
                         'between programs)')
    ap.add_argument('--obs-sweeps', type=int, default=4)
    ap.add_argument('--nuts-samples', type=int, default=150)
    ap.add_argument('--nuts-burn', type=int, default=150)
    ap.add_argument('--max-depth', type=int, default=5)
    ap.add_argument('--steps-per-call', type=int, default=4)
    ap.add_argument('--chains', type=int, default=2)
    ap.add_argument('--domain', default='(10000.0,200)')
    ap.add_argument('--outdir', default='carn_study')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--predictive-draws', type=int, default=16,
                    help='posterior-predictive draws per sampler '
                         '(0 disables the check)')
    args = ap.parse_args()

    import jax.numpy as jnp
    from jax import random

    from parasitoids_tpu.bayes.diagnostics import truth_diagnostics
    from parasitoids_tpu.bayes.map_fit import map_fit
    from parasitoids_tpu.bayes.model import BayesSetup
    from parasitoids_tpu.bayes.nuts import (NUTSConfig,
                                            make_transformed_logpdf,
                                            nuts_sample_stepwise)
    from parasitoids_tpu.bayes.priors import (MODEL_PARAM_NAMES,
                                              OBS_PARAM_NAMES)
    from parasitoids_tpu.bayes.sampler import (MCMCConfig, init_chain_state,
                                               run_mcmc)
    from parasitoids_tpu.config import Params
    from parasitoids_tpu.utils.cache import enable_compilation_cache
    import jax

    enable_compilation_cache()
    os.makedirs(args.outdir, exist_ok=True)

    p = Params()
    p.cmd_line_chg(['--carnarvon', 'domain_info=' + args.domain])
    p.PLOT = False
    p.OUTPUT = False
    p.PROB_MODEL = False
    setup = BayesSetup(p)

    with open('data/carnarvon_truth.json') as f:
        truth = json.load(f)
    truth_vec = np.array([truth['model'][n] for n in MODEL_PARAM_NAMES]
                         + truth['obs'])
    names = (list(MODEL_PARAM_NAMES) + list(OBS_PARAM_NAMES)
             + ['sent_obs_prob_{}'.format(k)
                for k in setup.locinfo.sent_ids])
    summary = {'date': time.strftime('%Y-%m-%d'), 'domain': args.domain,
               'r_dur': setup.r_dur, 'truth': dict(zip(names, truth_vec))}

    # ---- MAP -----------------------------------------------------------
    print('=== MAP ===', flush=True)
    tic = time.time()
    fit = map_fit(setup, n_steps=300, use_sprd=False)
    t_map = time.time() - tic
    print('MAP logp {:.2f} in {:.1f}s'.format(fit['logp'], t_map),
          flush=True)
    with open(os.path.join(args.outdir, 'map.json'), 'w') as f:
        json.dump({'logp': float(fit['logp']), 'wall_s': round(t_map, 1),
                   'theta': {n: float(v) for n, v in
                             zip(names, np.concatenate(
                                 [fit['model'], fit['obs']]))}},
                  f, indent=1)

    # ---- AM ------------------------------------------------------------
    # chunked like bayes/run.py: same math, state carried across bounded
    # programs that all share one compile
    print('=== AM: {} chains x ({} burn + {} samples, chunks of {}) ==='
          .format(args.chains, args.am_burn, args.am_samples,
                  args.am_chunk), flush=True)
    tic = time.time()
    total = args.am_burn + args.am_samples
    cfg = MCMCConfig(n_samples=args.am_chunk, obs_sweeps=args.obs_sweeps)
    traces = []
    for c in range(args.chains):
        state = init_chain_state(setup, random.PRNGKey(args.seed + c))
        trs = []
        done = 0
        while done < total:
            state, tr = jax.block_until_ready(run_mcmc(setup, state, cfg))
            trs.append(np.asarray(tr))
            done += args.am_chunk
        traces.append(np.concatenate(trs, axis=0)[:total])
        print('  chain {} done ({:.1f}s)'.format(c, time.time() - tic),
              flush=True)
    t_am = time.time() - tic
    am = np.stack(traces)[:, args.am_burn:, :]
    np.savez(os.path.join(args.outdir, 'am'), traces=am, sampler='am')

    # ---- NUTS (stepwise, chunked) ---------------------------------------
    print('=== NUTS: {} chains x ({} warmup + {} draws), depth {} ==='
          .format(args.chains, args.nuts_burn, args.nuts_samples,
                  args.max_depth), flush=True)
    logpdf, constrain, _ = make_transformed_logpdf(setup)
    z0 = jnp.asarray(fit['z'], jnp.float32)   # same z-packing as map_fit
    z0s = (jnp.broadcast_to(z0, (args.chains,) + z0.shape)
           + 0.01 * random.normal(random.PRNGKey(args.seed + 7),
                                  (args.chains,) + z0.shape))
    ncfg = NUTSConfig(num_warmup=args.nuts_burn,
                      num_samples=args.nuts_samples,
                      max_depth=args.max_depth, dense_mass=True)
    tic = time.time()

    def progress(phase, i, total):
        print('  {} {}/{} ({:.1f}s)'.format(phase, i, total,
                                            time.time() - tic), flush=True)

    out = nuts_sample_stepwise(
        logpdf, z0s, random.split(random.PRNGKey(args.seed + 13),
                                  args.chains),
        ncfg, progress=progress, steps_per_call=args.steps_per_call,
        checkpoint_path=os.path.join(args.outdir, 'nuts.ckpt.npz'))
    t_nuts = time.time() - tic
    theta = np.asarray(jax.vmap(jax.vmap(
        lambda z: jnp.concatenate(constrain(z)[:2])))(
            jnp.asarray(out['samples'])))
    logp = np.asarray(out['logp'])[..., None]
    np.savez(os.path.join(args.outdir, 'nuts'),
             traces=np.concatenate([theta, logp], axis=-1),
             sampler='nuts')

    # ---- diagnostics vs truth -------------------------------------------
    for name, tr, wall in (('am', am, t_am), ('nuts', theta, t_nuts)):
        block = truth_diagnostics(tr, names, truth_vec)
        block['wall_s'] = round(wall, 1)
        summary[name] = block
        if name == 'nuts':
            block['accept_rate'] = round(
                float(np.mean(out['accept_rate'])), 3)
            block['n_divergent'] = int(np.sum(out['n_divergent']))
        n_in = sum(v < 2 for v in block['truth_z'].values())
        print('[{}] max R-hat {}, {}/{} params within 2 posterior sd '
              'of truth'.format(name, block['max_rhat'], n_in,
                                len(names)), flush=True)

    # ---- posterior-predictive checks ---------------------------------
    # (VERDICT r1 item 5's "predictive checks" criterion): p-values per
    # observation channel and statistic + overlay plots, from the same
    # machinery as `python -m parasitoids_tpu.bayes.predictive`
    if args.predictive_draws > 0:
        from parasitoids_tpu.bayes.predictive import (plot_predictive,
                                                      posterior_predictive,
                                                      predictive_pvalues,
                                                      pvalue_report)
        for name, tr in (('am', am), ('nuts', theta)):
            pred = posterior_predictive(setup, tr,
                                        n_draws=args.predictive_draws,
                                        seed=args.seed)
            pv = predictive_pvalues(setup, pred)
            summary[name]['predictive_pvalues'] = pv
            png = plot_predictive(
                setup, pred,
                os.path.join(args.outdir, 'predictive_{}.png'.format(name)),
                label='posterior ({})'.format(name))
            print('=== predictive [{}] -> {} ==='.format(name, png),
                  flush=True)
            print(pvalue_report(pv), flush=True)

    with open(os.path.join(args.outdir, 'summary.json'), 'w') as f:
        json.dump(summary, f, indent=1)
    print('wrote', os.path.join(args.outdir, 'summary.json'))


if __name__ == '__main__':
    main()

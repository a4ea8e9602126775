"""Run the recorded SBC study (VERDICT r1 item 7) and write docs data.

Executes simulation-based calibration for BOTH samplers at an honest
reduced config — the full Kalbar model (18 wind days, every prior, every
observation block) on a coarser 201x201 @ 50 m grid — and records
rank-uniformity results (chi-square + randomized-PIT KS p-values) to
``sbc_study/``: one ranks npz + rank-histogram png per sampler and a
machine-readable summary JSON that docs/SBC.md quotes.

Usage:  python scripts/run_sbc_study.py [--replicates 100] [--sampler both]
(Run it on a GPU: at this size the CPU takes hours per arm.)
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
    ap.add_argument('--replicates', type=int, default=100)
    ap.add_argument('--sampler', choices=['am', 'nuts', 'both'],
                    default='both')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--outdir', default='sbc_study')
    # AM: 600 burn + 2400 kept, thin 30 -> L = 80 rank levels.  The first
    # study ran 200+400/thin 5: its ranks showed clean U-shapes on the
    # xi x obs-prob ridge — the finite-chain autocorrelation artifact of
    # Talts et al. §5.1, not sampler error (the directional skew that WAS
    # sampler error — the missing Hastings correction — is fixed and
    # regression-tested in tests/test_obs_sweep.py).  The longer window +
    # extra obs sweeps bring the draw set much closer to independence.
    ap.add_argument('--am-samples', type=int, default=2400)
    ap.add_argument('--am-burn', type=int, default=600)
    ap.add_argument('--am-thin', type=int, default=30)
    ap.add_argument('--am-chains', type=int, default=1,
                    help='independent chains pooled per replicate: draws '
                         'from several excursions instead of one, removing '
                         'the edge-piled ranks a near-window '
                         'autocorrelation time produces')
    ap.add_argument('--obs-sweeps', type=int, default=8)
    # NUTS: shorter chains are honest (each draw is far less correlated)
    ap.add_argument('--nuts-samples', type=int, default=240)
    ap.add_argument('--nuts-burn', type=int, default=None,
                    help='default 150, or 48 with --warm-start (the fixed '
                         'Hessian metric leaves only step size to adapt)')
    ap.add_argument('--nuts-thin', type=int, default=3)
    ap.add_argument('--max-depth', type=int, default=5)
    ap.add_argument('--steps-per-call', type=int, default=25)
    ap.add_argument('--warm-start', action='store_true',
                    help='NUTS: fixed dense mass matrix from the Hessian '
                         'at each replicate truth (bayes/sbc.py run_sbc)')
    ap.add_argument('--ridge', action='store_true',
                    help='NUTS: per-replicate ridge whitening at the '
                         'truth with Welford adaptation ON (the warm '
                         'arm\'s controlled experiment, VERDICT r4 '
                         'item 3); summary block name gains a _ridge '
                         'suffix')
    args = ap.parse_args()
    if args.nuts_burn is None:
        args.nuts_burn = 48 if (args.warm_start or args.ridge) else 150

    from jax import random

    from parasitoids_tpu.bayes.run import build_setup
    from parasitoids_tpu.bayes.sbc import (plot_sbc, run_sbc,
                                           sbc_ecdf_pvals, sbc_uniformity)
    from parasitoids_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    os.makedirs(args.outdir, exist_ok=True)

    # honest reduced config: the FULL Kalbar model at half resolution
    setup = build_setup(['domain_info=(10000.0,100)'])
    summary_path = os.path.join(args.outdir, 'summary.json')
    summary = {'config': 'kalbar, 201x201 @ 50 m, 18 days, full model',
               'samplers': {}}
    if os.path.exists(summary_path):
        # merge with an earlier partial study (sessions can be preempted
        # mid-run; each sampler's block is written as soon as it finishes).
        # An unreadable file (kill landed mid-write) must not brick the
        # retry — treat it as empty and let this run rewrite it.
        try:
            with open(summary_path) as f:
                summary['samplers'] = json.load(f).get('samplers', {})
        except (json.JSONDecodeError, OSError) as e:
            print('ignoring unreadable {}: {}'.format(summary_path, e),
                  flush=True)

    plans = []   # (label, sampler, kwargs): the label names the artifacts/
    # summary block (nuts_ridge for the ridge-whitened arm), the sampler is
    # what run_sbc dispatches on
    if args.sampler in ('am', 'both'):
        plans.append(('am', 'am', dict(n_samples=args.am_samples,
                                       burn=args.am_burn,
                                       thin=args.am_thin,
                                       obs_sweeps=args.obs_sweeps,
                                       chains=args.am_chains)))
    if args.sampler in ('nuts', 'both'):
        plans.append(('nuts_ridge' if args.ridge else 'nuts', 'nuts',
                      dict(n_samples=args.nuts_samples,
                           burn=args.nuts_burn,
                           thin=args.nuts_thin,
                           max_depth=args.max_depth,
                           stepwise=True,
                           steps_per_call=args.steps_per_call,
                           warm_start=args.warm_start,
                           ridge=args.ridge)))

    for name, samp, kw in plans:
        print('=== SBC [{}]: {} replicates ==='.format(
            name, args.replicates), flush=True)
        # per-replicate checkpoint: a killed/timed-out arm resumes exactly
        # (replicate RNG depends only on the index) instead of restarting
        ckpt = os.path.join(args.outdir, 'sbc_{}.ckpt.npz'.format(name))
        tic = time.time()
        out = run_sbc(setup, args.replicates, random.PRNGKey(args.seed),
                      seed=args.seed, verbose=True, sampler=samp,
                      checkpoint_path=ckpt, **kw)
        dt = time.time() - tic
        chi2 = sbc_uniformity(out['ranks'], out['L'])
        ks = sbc_ecdf_pvals(out['ranks'], out['L'], seed=args.seed)
        base = os.path.join(args.outdir, 'sbc_{}'.format(name))
        np.savez(base + '_ranks', ranks=out['ranks'], L=out['L'],
                 truths=out['truths'], names=np.asarray(out['names']))
        plot_sbc(out, base + '.png')
        n_flag = int(np.sum(np.minimum(chi2, ks) < 0.01))
        # provenance lives in the sampler block, not at top level: merged
        # summaries may hold blocks from runs with different settings
        summary['samplers'][name] = {
            'replicates': args.replicates,
            'seed': args.seed,
            'date': time.strftime('%Y-%m-%d'),
            'chain_config': kw,
            'wall_s': round(dt, 1),
            'resumed_at_replicate': out['resumed_at'] or None,
            'L': int(out['L']),
            'dim': int(out['ranks'].shape[1]),
            'chi2_pvals': {n: round(float(p), 4)
                           for n, p in zip(out['names'], chi2)},
            'ks_pvals': {n: round(float(p), 4)
                         for n, p in zip(out['names'], ks)},
            'min_chi2_p': round(float(chi2.min()), 4),
            'min_ks_p': round(float(ks.min()), 4),
            'n_flagged_p_lt_0.01': n_flag,
        }
        print('[{}] done in {:.1f}s: min chi2 p {:.3f}, min KS p {:.3f}, '
              '{} flagged'.format(name, dt, chi2.min(), ks.min(), n_flag),
              flush=True)
        tmp = summary_path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(summary, f, indent=1)
        os.replace(tmp, summary_path)
        print('wrote', summary_path, flush=True)
        # arm complete; partial state (transient ckpt + its durable twin,
        # see bayes/sbc.py) superseded by the final _ranks artifact
        for stale in (ckpt, base + '_partial.npz'):
            if os.path.exists(stale):
                os.remove(stale)


if __name__ == '__main__':
    main()

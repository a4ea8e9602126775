"""Summarize a recorded NUTS trace against convergence targets (min ESS,
max R-hat, min ESS/hr at the 801² Kalbar config).

Usage:
  python scripts/analyze_nuts_run.py <store.npz> [--log <run.log>]
      [--targets minESS,maxRhat,essPerHr] [-o out.json]

Writes ``<store>_summary.json``: per-parameter pooled ESS and split
R-hat, min/median ESS/hr (sampling-phase wall time parsed from the run
log's ``sample i/N (t s)`` progress stamps), divergence count, and a
verdict line per target.  CPU-only (no forward sims).
"""

import argparse
import json
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)


def sampling_wall_s(log_path, n_samples):
    """Sampling-phase wall seconds from the progress stamps.

    The elapsed counter in ``sample i/N (t s)`` restarts at every resume
    segment (each ``NUTS: ... (resuming)...`` header starts a fresh
    timer), so a single global fit of t against i can even go *negative*
    on a resumed log.  Instead: split the stamps into segments at each
    sampler header, pool the consecutive (di, dt) deltas within
    segments, and scale the pooled per-sample rate to the full run."""
    segments, cur = [], []
    with open(log_path) as f:
        for line in f:
            if re.search(r'NUTS: .*samples', line):
                if len(cur) > 1:
                    segments.append(cur)
                cur = []
                continue
            m = re.search(r'sample (\d+)/(\d+) \(([\d.]+) s\)', line)
            if m:
                cur.append((int(m.group(1)), float(m.group(3))))
    if len(cur) > 1:
        segments.append(cur)
    di_tot = dt_tot = 0.0
    for seg in segments:
        for (i0, t0), (i1, t1) in zip(seg, seg[1:]):
            if i1 > i0 and t1 > t0:
                di_tot += i1 - i0
                dt_tot += t1 - t0
    if di_tot <= 0:
        return None
    return dt_tot / di_tot * n_samples


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('store')
    ap.add_argument('--log', default=None)
    ap.add_argument('--targets', default='100,1.01,909',
                    help='minESS,maxRhat,minESSperHr')
    ap.add_argument('-o', '--out', default=None)
    args = ap.parse_args()
    t_ess, t_rhat, t_rate = (float(x) for x in args.targets.split(','))

    from parasitoids_tpu.bayes.diagnostics import (effective_sample_size,
                                                   gelman_rubin)
    from parasitoids_tpu.viz.bayes_plot import _param_names

    path = args.store if args.store.endswith('.npz') else args.store + '.npz'
    with np.load(path) as d:
        tr = d['traces']
        extra = {k: d[k] for k in ('step_size', 'inv_mass') if k in d.files}
    names = _param_names(tr.shape[-1])[:-1]
    dim = len(names)
    ess = np.array([sum(effective_sample_size(tr[c, :, j])
                        for c in range(tr.shape[0]))
                    for j in range(dim)])
    rhat = (np.atleast_1d(gelman_rubin(tr[:, :, :dim]))
            if tr.shape[0] > 1 else np.full(dim, np.nan))
    log_path = args.log or path[:-4] + '.log'
    wall = (sampling_wall_s(log_path, tr.shape[1])
            if os.path.exists(log_path) else None)
    ess_rate = ess * 3600.0 / wall if wall else None

    order = np.argsort(ess)
    summary = {
        'store': path,
        'chains': int(tr.shape[0]),
        'draws_per_chain': int(tr.shape[1]),
        'min_ess': round(float(ess.min()), 1),
        'min_ess_param': names[int(order[0])],
        'median_ess': round(float(np.median(ess)), 1),
        'max_rhat': (round(float(np.nanmax(rhat)), 4)
                     if np.isfinite(rhat).any() else None),
        'max_rhat_param': (names[int(np.nanargmax(rhat))]
                           if np.isfinite(rhat).any() else None),
        'sampling_wall_s': round(wall, 1) if wall else None,
        'min_ess_per_hr': (round(float(ess_rate.min()), 1)
                           if ess_rate is not None else None),
        'median_ess_per_hr': (round(float(np.median(ess_rate)), 1)
                              if ess_rate is not None else None),
        # the comparison metric of the earlier recorded runs (ESS/hr on
        # g_aw), kept for like-for-like reading of their summaries
        'g_aw_ess_per_hr': (round(float(ess_rate[names.index('g_aw')]), 1)
                            if ess_rate is not None else None),
        'per_param': {n: {'ess': round(float(ess[j]), 1),
                          'rhat': (round(float(rhat[j]), 4)
                                   if np.isfinite(rhat[j]) else None)}
                      for j, n in enumerate(names)},
        'targets': {
            'min_ess>={:.0f}'.format(t_ess): bool(ess.min() >= t_ess),
            'max_rhat<={:g}'.format(t_rhat): (
                bool(np.nanmax(rhat) <= t_rhat)
                if np.isfinite(rhat).any() else None),
            'g_aw_ess_per_hr>={:.0f}'.format(t_rate): (
                bool(ess_rate[names.index('g_aw')] >= t_rate)
                if ess_rate is not None else None),
        },
    }
    if 'step_size' in extra:
        summary['step_size'] = np.asarray(extra['step_size']).tolist()
    out = args.out or path[:-4] + '_summary.json'
    with open(out, 'w') as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != 'per_param'}, indent=1))
    worst = [(names[int(j)], round(float(ess[j]), 1),
              (round(float(rhat[j]), 3) if np.isfinite(rhat[j]) else None))
             for j in order[:5]]
    print('5 slowest-mixing parameters (name, pooled ESS, R-hat):')
    for w in worst:
        print('  {:>18s}  ESS {:>8}  R-hat {}'.format(*w))
    print('wrote', out)


if __name__ == '__main__':
    main()

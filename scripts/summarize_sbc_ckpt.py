"""Write a (partial) SBC summary block from a per-replicate checkpoint.

``run_sbc`` checkpoints (ranks, truths, done) after every replicate; this
derives the same chi-square / KS uniformity block ``run_sbc_study`` writes
at arm completion, from whatever is done so far, and merges it into the
study's summary.json marked ``"partial": true``, so an arm killed mid-run
still leaves recorded, up-to-date evidence.

Usage: python scripts/summarize_sbc_ckpt.py <ckpt.npz> <sampler> [outdir]
e.g.   python scripts/summarize_sbc_ckpt.py sbc_study/sbc_nuts.ckpt.npz \
           nuts sbc_study
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)


def main():
    ckpt, name = sys.argv[1], sys.argv[2]
    outdir = sys.argv[3] if len(sys.argv) > 3 else os.path.dirname(ckpt)
    from parasitoids_tpu.bayes.sbc import sbc_ecdf_pvals, sbc_uniformity

    if not os.path.exists(ckpt):
        # a COMPLETED arm deletes its checkpoint after run_sbc_study writes
        # the final ranks npz + summary block — that is success, not an
        # error (a FileNotFoundError here once crashed a study run)
        final = os.path.join(outdir, 'sbc_{}_ranks.npz'.format(name))
        if os.path.exists(final):
            print('no checkpoint at {} but final ranks exist at {} — arm '
                  'complete, summary already recorded'.format(ckpt, final))
            return
        # a VM recycle deletes the gitignored transient ckpt but leaves
        # the committed durable twin (bayes/sbc.py); summarize from that
        durable = os.path.join(outdir, 'sbc_{}_partial.npz'.format(name))
        if os.path.exists(durable):
            print('transient checkpoint gone; summarizing the durable '
                  'twin {}'.format(durable))
            ckpt = durable
        else:
            print('no checkpoint at {} and no final ranks — arm never '
                  'started or produced nothing'.format(ckpt))
            sys.exit(1)

    with np.load(ckpt) as d:
        done, L = int(d['done']), int(d['L'])
        seed = int(d['seed'])
        ranks = d['ranks'][:done]
        names = [str(n) for n in d['names']]
    if done == 0:
        print('checkpoint has no completed replicates; nothing to do')
        return

    chi2 = sbc_uniformity(ranks, L)
    ks = sbc_ecdf_pvals(ranks, L, seed=seed)
    n_flag = int(np.sum(np.minimum(chi2, ks) < 0.01))
    block = {
        'partial': True,
        'replicates': done,
        'seed': seed,
        'date': time.strftime('%Y-%m-%d'),
        'L': L,
        'dim': int(ranks.shape[1]),
        'chi2_pvals': {n: round(float(p), 4) for n, p in zip(names, chi2)},
        'ks_pvals': {n: round(float(p), 4) for n, p in zip(names, ks)},
        'min_chi2_p': round(float(chi2.min()), 4),
        'min_ks_p': round(float(ks.min()), 4),
        'n_flagged_p_lt_0.01': n_flag,
    }

    summary_path = os.path.join(outdir, 'summary.json')
    summary = {'samplers': {}}
    if os.path.exists(summary_path):
        try:
            with open(summary_path) as f:
                summary = json.load(f)
        except (json.JSONDecodeError, OSError):
            pass
    existing = summary.setdefault('samplers', {}).get(name, {})
    if not existing.get('partial', True):
        print('{} already holds a COMPLETE {} block; leaving it'.format(
            summary_path, name))
        return
    summary['samplers'][name] = block
    tmp = summary_path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(summary, f, indent=1)
    os.replace(tmp, summary_path)
    print('[{}] partial summary from {} replicates: min chi2 p {:.3f}, '
          'min KS p {:.3f}, {} flagged -> {}'.format(
              name, done, chi2.min(), ks.min(), n_flag, summary_path))


if __name__ == '__main__':
    main()

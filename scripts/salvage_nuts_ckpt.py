"""Recover a recorded NUTS trace from a stepwise checkpoint.

The stepwise NUTS driver checkpoints its complete draw state — including
every completed draw — every ``--checkpoint-every`` transitions
(bayes/nuts.py nuts_sample_stepwise).  When a run cannot finish inside a
session budget (deep-tree stretches at full scale can triple the
s/transition mid-run), the draws already taken are a perfectly valid,
shorter MCMC run; this tool writes them out in exactly the format
``bayes/run.py run_nuts`` saves at completion (constrained-space
``traces`` + z samples + metric), so every analysis CLI
(--analyze, bayes.predictive, analyze_real_fit) accepts the store.
Checkpoint/recovery role of the reference's try/except -> db.close
(Bayes_Run.py:500-503) applied to the draws themselves.

Usage:
  python scripts/salvage_nuts_ckpt.py <db> [key=value overrides...]
e.g.
  python scripts/salvage_nuts_ckpt.py carn_study/real/nuts \
      dataset=carnreal 'domain_info=(10000.0,200)'

Writes <db>.npz (refusing to clobber an existing completed store) with
``salvaged_draws`` recording the recovered count.  The checkpoint itself
is left untouched, so a later session can still resume and finish the
full plan.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)


def main():
    db = sys.argv[1].removesuffix('.npz')
    overrides = sys.argv[2:]
    ckpt = db + '.ckpt.npz'
    out_path = db + '.npz'
    if os.path.exists(out_path):
        print('{} already exists — nothing to salvage'.format(out_path))
        return
    if not os.path.exists(ckpt):
        print('no checkpoint at {}'.format(ckpt))
        sys.exit(1)

    with np.load(ckpt) as d:
        if str(d['phase']) != 'draw':
            print('checkpoint is still in warmup (no draws to salvage)')
            sys.exit(1)
        n = min(int(d['i']), d['samples'].shape[1])
        samples = np.asarray(d['samples'][:, :n])
        logp = np.asarray(d['logp'][:, :n])
        step_size = np.asarray(d['step_size'])
        inv_mass = np.asarray(d['inv_mass'])
        sig = [int(v) for v in d['cfg_sig']]
        gibbs = bool(sig[6]) if len(sig) > 6 else False
        # a --gibbs-n run samples n_periods: the checkpoint records the
        # per-draw values in 'ns'; constrain() below pins slot 13 at 30,
        # so the salvaged trace must restore the sampled column (a
        # silently wrong n_periods column passes every analysis CLI)
        ns = np.asarray(d['ns'][:, :n]) if gibbs else None
        if gibbs and ns.shape[1] != n:
            print('gibbs checkpoint: ns column count {} != draws {} — '
                  'refusing to salvage'.format(ns.shape[1], n))
            sys.exit(1)
    if n == 0:
        print('checkpoint holds no completed draws')
        sys.exit(1)

    # a --mass ridge run checkpoints U-SPACE states: map them back through
    # the run's whitening sidecar (without it the salvage would silently
    # mislabel u as z)
    wh_path = db + '.whiten.npz'
    if os.path.exists(wh_path):
        with np.load(wh_path) as wz:
            L, center = wz['L'], wz['center']
        samples = (np.asarray(samples, np.float64) @ L.T
                   + center).astype(np.float32)
        print('ridge run: mapped u-space draws through {}'.format(wh_path))

    # constrain is pure bijection math — no forward model, instant on CPU,
    # and a CPU process leaves the card to the chain it salvages
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax
    import jax.numpy as jnp

    from parasitoids_tpu.bayes.nuts import make_transformed_logpdf
    from parasitoids_tpu.bayes.run import build_setup

    setup = build_setup(overrides)
    _, constrain, _ = make_transformed_logpdf(setup)
    theta = np.array(jax.vmap(jax.vmap(
        lambda z: jnp.concatenate([constrain(z)[0], constrain(z)[1]])))(
            jnp.asarray(samples)))
    if gibbs:
        theta[:, :, 13] = ns      # the sampled n_periods column
    traces = np.concatenate([theta, logp[..., None]], axis=-1)
    np.savez(out_path, traces=traces, z_samples=samples,
             step_size=step_size, inv_mass=inv_mass, sampler='nuts',
             salvaged_draws=n)
    print('salvaged {} draws x {} chains from {} -> {}'.format(
        n, traces.shape[0], ckpt, out_path))


if __name__ == '__main__':
    main()

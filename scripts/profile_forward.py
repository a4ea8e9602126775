"""Profiling harness for the forward simulation (SURVEY C27 equivalent).

The reference profiles one ``prob_mass`` call with cProfile
(profile_prob_mass.py:18-31); here the unit of work is the full jitted
forward simulation, so the harness reports:

* wall-clock per phase (kernel build / propagation) with chained-dependency
  timing,
* XLA's static cost analysis (FLOPs, bytes accessed) per compiled program,
* optionally a ``jax.profiler`` device trace for TensorBoard / Perfetto
  (``--trace DIR``).

Usage:
    python scripts/profile_forward.py [--trace /tmp/trace] [--iters N]
        [key=value Params overrides...]
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--trace', default=None,
                    help='write a jax.profiler trace to this directory')
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('overrides', nargs='*')
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from parasitoids_tpu.config import Params
    from parasitoids_tpu.models.forward import (build_all_kernels,
                                                setup_forward)
    from parasitoids_tpu.models.solver import propagate_pop
    from parasitoids_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    print('backend:', jax.default_backend(), jax.devices())

    p = Params()
    p.cmd_line_chg(['--kalbar'])
    p.PLOT = False
    p.OUTPUT = False
    p.PROB_MODEL = False
    for ov in args.overrides:
        if '=' in ov:
            k, _, v = ov.partition('=')
            p.chg_param(k, v)
    s = setup_forward(p)
    hparams = tuple(np.float32(v)
                    for v in (p.lam, *p.g_params, *p.f_params))
    w = jnp.asarray(s.dist_weights, jnp.float32)

    def kphase(mu_r):
        k, _ = build_all_kernels(
            s.wind_flat, s.wind_cumsum, hparams, p.Dparams, p.Dlparams,
            mu_r, jnp.int32(p.n_periods), s.rad_dist, jnp.int32(0),
            s.kcfg, s.ndays)
        return k

    # --- compile + static cost analysis ---------------------------------
    lowered = jax.jit(kphase).lower(jnp.float32(p.mu_r))
    t0 = time.time()
    compiled = lowered.compile()
    print('kernel-phase compile: {:.1f} s'.format(time.time() - t0))
    ca = compiled.cost_analysis() or {}
    print('kernel-phase cost analysis: flops={:.3g} bytes={:.3g}'.format(
        ca.get('flops', float('nan')),
        ca.get('bytes accessed', float('nan'))))

    k0 = kphase(jnp.float32(p.mu_r))
    conv = jax.jit(lambda k: propagate_pop(k, int(p.r_dur),
                                           float(p.r_number), w, s.scfg))
    lowered_c = conv.lower(k0)
    t0 = time.time()
    compiled_c = lowered_c.compile()
    print('conv-phase compile: {:.1f} s'.format(time.time() - t0))
    cc = compiled_c.cost_analysis() or {}
    print('conv-phase cost analysis: flops={:.3g} bytes={:.3g}'.format(
        cc.get('flops', float('nan')),
        cc.get('bytes accessed', float('nan'))))

    # --- chained wall-clock timing --------------------------------------
    def chain_time(fn, seed, n):
        acc = seed
        float(fn(acc).ravel()[0])           # warm
        t0 = time.time()
        for _ in range(n):
            out = fn(acc)
            acc = seed + out.ravel()[0] * jnp.float32(1e-12)
        float(acc.ravel()[0])
        return (time.time() - t0) / n

    kt = chain_time(kphase, jnp.float32(p.mu_r), args.iters)
    print('kernel phase: {:.4f} s/sim ({:.1f} sim-days/s)'.format(
        kt, s.ndays / kt))
    # conv chained via kernel perturbation
    acc = k0
    float(conv(acc)[-1, 0, 0])
    t0 = time.time()
    for _ in range(args.iters):
        f = conv(acc)
        acc = k0 + f[-1][None] * jnp.float32(1e-20)
    float(acc[0, 0, 0])
    ct = (time.time() - t0) / args.iters
    print('conv phase: {:.4f} s/sim'.format(ct))
    print('total: {:.4f} s/sim -> {:.0f} sims/hr'.format(
        kt + ct, 3600.0 / (kt + ct)))

    # --- optional device trace ------------------------------------------
    if args.trace:
        import jax.profiler
        with jax.profiler.trace(args.trace):
            f = conv(kphase(jnp.float32(p.mu_r)))
            float(f[-1, 0, 0])
        print('trace written to', args.trace)


if __name__ == '__main__':
    main()

"""Head-to-head: sequential (lax.map + switch-BVN) vs batched
(vmap + select-BVN) particle rejuvenation.

The SMC anneal advances N particles with ``n_moves`` AM transitions per
stage.  The incumbent executes particles sequentially under ``lax.map``
with the scalar-rho program; the challenger vmaps the whole move program
over particles with the fixed-G select BVN scheme
(ops/bvn.bvn_cell_masses_batched).  This script times both at the
synthetic-Carnarvon SMC config (401^2 x 30 days — the round-5 flagship
workload) and prints per-particle move costs and the stage-throughput
ratio.  Adoption rule: >= 2x stage-throughput -> flip PARA_SMC_BATCHED
on; otherwise commit the negative result with these numbers.

Usage: python scripts/measure_batched_ensemble.py [P ...]  (default 32 64)
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.chdir(REPO)

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
from jax import random                                      # noqa: E402


def time_move(move, states, n_rep=3):
    out = jax.block_until_ready(move(states, jnp.float32(0.5), None))
    tic = time.time()
    for _ in range(n_rep):
        out = jax.block_until_ready(move(out, jnp.float32(0.5), None))
    return (time.time() - tic) / n_rep


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [32, 64]
    from parasitoids_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from parasitoids_tpu.config import Params
    from parasitoids_tpu.bayes.model import BayesSetup
    from parasitoids_tpu.bayes.smc import _move_prog, init_smc_particles

    p = Params()
    p.cmd_line_chg(['--carnarvon'])
    p.PLOT = False
    p.OUTPUT = False
    p.PROB_MODEL = False
    p.domain_info = (10000.0, 200)
    setup = BayesSetup(p)
    n_moves = 2

    platform = jax.devices()[0].platform
    results = {'config': 'carnarvon 401^2 x {} days, n_moves={}'.format(
        setup.ndays, n_moves), 'platform': platform, 'sizes': {}}

    for P in sizes:
        key = random.PRNGKey(0)
        t0 = time.time()
        states = jax.block_until_ready(init_smc_particles(setup, key, P))
        init_s = time.time() - t0
        row = {'init_s': round(init_s, 2)}

        # incumbent: lax.map, scalar-rho
        t0 = time.time()
        move_seq = _move_prog(setup, n_moves, 0.05, None, 1, False)
        try:
            seq_s = time_move(move_seq, states)
            row['seq_compile_s'] = round(time.time() - t0 - seq_s, 1)
            row['seq_stage_s'] = round(seq_s, 3)
            row['seq_ms_per_particle_move'] = round(
                1e3 * seq_s / (P * n_moves), 2)
        except Exception as e:                              # noqa: BLE001
            row['seq_error'] = repr(e)[:200]

        # challenger: vmap, select-BVN, XLA scatter
        bset = setup.with_batched_bvn()
        t0 = time.time()
        move_bat = _move_prog(bset, n_moves, 0.05, None, 1, True)
        try:
            bat_s = time_move(move_bat, states)
            row['bat_compile_s'] = round(time.time() - t0 - bat_s, 1)
            row['bat_stage_s'] = round(bat_s, 3)
            row['bat_ms_per_particle_move'] = round(
                1e3 * bat_s / (P * n_moves), 2)
            if 'seq_stage_s' in row:
                row['speedup_bat_over_seq'] = round(seq_s / bat_s, 2)
        except Exception as e:                              # noqa: BLE001
            row['bat_error'] = repr(e)[:200]

        results['sizes'][str(P)] = row
        print(json.dumps({P: row}), flush=True)

    out = 'runs/batched_ensemble_measure.json'
    os.makedirs('runs', exist_ok=True)
    with open(out, 'w') as f:
        json.dump(results, f, indent=1)
    print('wrote', out)


if __name__ == '__main__':
    main()

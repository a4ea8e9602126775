"""Regenerate the checked-in golden runs under tests/golden/.

Run this ONLY after confirming reference parity still holds (the oracle
parity tests in tests/test_daily_kernel.py and tests/test_solver.py import
the reference at /root/reference and must be green first) — goldens guard
against *unintended* drift, so an intended numerical change (e.g. a
more-stable formulation with ulp-level differences) is the only valid
reason to regenerate.

Usage: JAX_PLATFORMS=cpu python scripts/regen_goldens.py
"""

import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from parasitoids_tpu.io.save import save_run
from parasitoids_tpu.models.forward import simulate
from tests.test_golden import GOLDEN, _run_config


def main():
    configs = [
        ('kalbar_prob_tiny', _run_config(False)),
        ('kalbar_pop_tiny', _run_config(True)),
        ('carnarvon_pop_tiny', _run_config(True, site='--carnarvon',
                                           ndays=7)),
    ]
    for name, p in configs:
        fields, days = simulate(p)
        out = os.path.join(GOLDEN, name)
        save_run(out, fields, days, params=p)
        print('wrote', out, 'days', list(days))


if __name__ == '__main__':
    main()

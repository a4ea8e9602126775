#!/bin/bash
# Run the --runslow tier ONE FILE PER PROCESS.
#
# Why: a single long pytest process accumulates hundreds of XLA:CPU JIT
# executables and eventually segfaults inside a compile (observed
# reproducibly at tests/test_nuts.py::test_gibbs_nuts_on_parasitoid_model
# when ~50 tests ran first; the same test passes in a fresh process).
# Fresh processes also give honest per-file timings.
#
# Usage:
#   scripts/run_slow_tier.sh            # full-fidelity slow tier
#   PARA_FAST_SLOW=1 scripts/run_slow_tier.sh   # <=15-min smoke tier
#
# Exit code: number of failing files (0 = green).
set -u
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=${JAX_PLATFORMS:-cpu}

FILES=$(grep -rln "pytest.mark.slow\|pytestmark = pytest.mark.slow" tests/test_*.py | sort)
fails=0
t0=$(date +%s)
for f in $FILES; do
    ft0=$(date +%s)
    if python -m pytest "$f" --runslow -q > /tmp/slow_tier_last.log 2>&1; then
        status=ok
    else
        status="FAIL(rc=$?)"
        fails=$((fails + 1))
        tail -5 /tmp/slow_tier_last.log
    fi
    printf '%-40s %-10s %4ds  %s\n' "$f" "$status" $(( $(date +%s) - ft0 )) \
        "$(grep -Eo '[0-9]+ (passed|failed|skipped)[^=]*' /tmp/slow_tier_last.log | tail -1)"
done
echo "slow tier: $fails failing file(s), $(( $(date +%s) - t0 )) s total" \
     "(PARA_FAST_SLOW=${PARA_FAST_SLOW:-unset})"
exit $fails

#!/usr/bin/env bash
# Per-file sharded test runner: one pytest process
# per test file, so a single XLA:CPU compile-cache/memory blowup (the
# round-4 full-suite run SEGFAULTED inside backend_compile_and_load
# after ~40 min in ONE process; every file passes in isolation) cannot
# take the whole suite down, and total memory stays bounded.
#
# Usage:
#   scripts/run_tests_sharded.sh            # full suite, sharded
#   scripts/run_tests_sharded.sh -m 'not slow'   # fast subset
#
# Exit code: number of failing files (0 = green).
set -u
cd "$(dirname "$0")/.."
EXTRA=("$@")
FAIL=0
SUMMARY=""
for f in tests/test_*.py; do
    t0=$(date +%s)
    if out=$(timeout 1200 python -m pytest "$f" -q "${EXTRA[@]}" 2>&1); then
        rc=0
    else
        rc=$?
    fi
    dt=$(( $(date +%s) - t0 ))
    line=$(echo "$out" | grep -E "passed|failed|error|no tests ran" | tail -1)
    # rc=5 is pytest's "no tests collected" (e.g. everything deselected)
    if [ "$rc" -ne 0 ] && [ "$rc" -ne 5 ]; then
        FAIL=$((FAIL + 1))
        echo "FAIL  $f (${dt}s, rc=$rc): $line"
        echo "$out" | tail -30
    else
        echo "ok    $f (${dt}s): $line"
    fi
    SUMMARY="$SUMMARY\n$f ${dt}s rc=$rc"
done
echo "-----"
echo "failing files: $FAIL"
exit "$FAIL"

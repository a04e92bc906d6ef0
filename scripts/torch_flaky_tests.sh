#!/bin/bash
# Repeated CPU runs of the two tests that once failed at random in a full
# test run, each on a checkout TREE (this one, or a parent commit unpacked
# elsewhere), with a log per run under OUT:
#
#   scripts/torch_flaky_tests.sh sharded TREE OUT [N=50]
#       N runs of tests/test_torch_checkpoint_sharded.py while -n 6 of every
#       other test file runs beside it in a loop; OUT/rcs.txt has each
#       run's exit code, OUT/run_<i>.log its output.
#   scripts/torch_flaky_tests.sh native TREE OUT [N=10] [WORKERS=2]
#       N runs of tests/test_native.py and tests/test_torch_native.py under
#       -n WORKERS --dist loadfile, each from a tree without
#       native/libtrajlog.so (and without the port's build of it); OUT/native.txt
#       has each run's result for test_files_equal_across_packages_and_codecs.
set -u
mode=$1; tree=$(cd "$2" && pwd); mkdir -p "$3"; out=$(cd "$3" && pwd)
cd "$tree"
export JAX_PLATFORMS=cpu PYTHONDONTWRITEBYTECODE=1
case $mode in
  sharded)
    n=${4:-50}
    : > "$out/rcs.txt"
    ( while [ ! -e "$out/done" ]; do
        timeout 1500 python -m pytest tests/ -q -m 'not slow' -p no:cacheprovider -p xdist \
          -n 6 --dist loadfile -p no:randomly \
          --ignore=tests/test_torch_checkpoint_sharded.py >> "$out/load.log" 2>&1
      done ) &
    load=$!
    sleep 20
    for i in $(seq 1 "$n"); do
      python -m pytest tests/test_torch_checkpoint_sharded.py -q -p no:cacheprovider \
        -p no:randomly > "$out/run_$i.log" 2>&1
      echo "$i rc=$?" >> "$out/rcs.txt"
    done
    touch "$out/done"
    pkill -P "$load"; wait
    rm -f "$out/done"
    echo "aborts: $(grep -l 'terminate called\|exited with code' "$out"/run_*.log | wc -l) of $n runs"
    ;;
  native)
    n=${4:-10}; workers=${5:-2}
    : > "$out/native.txt"
    for i in $(seq 1 "$n"); do
      rm -f native/libtrajlog.so; rm -rf cartpoleplusplus_tpu_torch/_build
      python -m pytest tests/test_native.py tests/test_torch_native.py -q -p no:cacheprovider \
        -p xdist -n "$workers" --dist loadfile -p no:randomly -rA 2>&1 \
        | grep -E "test_files_equal_across_packages_and_codecs" | head -1 >> "$out/native.txt"
    done
    echo "passed: $(grep -c '^PASSED' "$out/native.txt") of $n runs"
    ;;
  *) echo "usage: $0 sharded|native TREE OUT [N] [WORKERS]" >&2; exit 2 ;;
esac

#!/bin/bash
# Parent against change on one card: chip_smoke.py of a parent tree and of
# this tree in turns (parent, change, change, parent), then the card tests
# of this tree, with the card's clocks, power and temperature sampled every
# half second beside them.
#
#   git archive <parent> | tar -x -C build/parent --exclude=.jax_cache
#   bash tools/chip_smoke_ab.sh [build/parent]
#
# Run from the repository root on a machine with the card.  Logs go to
# chiprun_out/: smoke_{parent,change,change2,parent2}.log, cuda_tests.log
# and smi.csv.
set -u
ROOT=$(pwd)
PARENT=$(cd "${1:-build/parent}" && pwd)
OUT=$ROOT/chiprun_out
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
nvidia-smi --query-gpu=timestamp,clocks.sm,clocks.max.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active \
  --format=csv -lms 500 > "$OUT/smi.csv" 2>&1 &
SMI=$!
trap 'kill $SMI 2>/dev/null' EXIT
for tag in parent change change2 parent2; do
  case $tag in parent*) dir=$PARENT ;; *) dir=$ROOT ;; esac
  start=$(date +%s)
  (cd "$dir" && timeout 420 python3 chip_smoke.py > "$OUT/smoke_$tag.log" 2>&1)
  echo "$tag rc=$? $(( $(date +%s) - start )) s"
  tail -n 2 "$OUT/smoke_$tag.log"
done
start=$(date +%s)
timeout 600 python3 -m pytest --noconftest -p no:cacheprovider -q \
  tests/test_torch_cuda.py -m cuda > "$OUT/cuda_tests.log" 2>&1
echo "card tests rc=$? $(( $(date +%s) - start )) s"
tail -n 3 "$OUT/cuda_tests.log"

#!/bin/sh
# The readings a cell's limits are set from, on the card: the
# control (TF32) at the cell's size on three seeds, then the program over
# the given seeds in short windows; each record in $OUT (default
# build/benchmark_runs).
#   sh benchmark/tests/chip_readings.sh <cell> <seconds> <seed>...
set -u
cell=$1; secs=$2; shift 2
out=${OUT:-build/benchmark_runs}/readings
mkdir -p "$out"
python3 benchmark/control.py --workload "$cell" --seeds 7001 7002 7003 \
    > "$out/$cell.control" 2> "$out/$cell.control.err"
echo "control rc $?"; cat "$out/$cell.control"
for s in "$@"; do
  python3 benchmark/run.py --workload "$cell" --seed "$s" --seconds "$secs" --trace 0 \
      > "$out/$cell.$s.out" 2> "$out/$cell.$s.err"
  echo "seed $s rc $? $(tail -c 330 "$out/$cell.$s.out")"
done

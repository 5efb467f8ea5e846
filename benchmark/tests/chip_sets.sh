#!/bin/sh
# A cell's spread on the card: two sets of six runs on the same six seeds
# at the given window, three traced runs and three more untraced runs on
# six more seeds; each run's record in $OUT (default build/benchmark_runs).
#   sh benchmark/tests/chip_sets.sh <cell> <seconds> <first seed>
set -u
cell=$1; secs=$2; s0=$3
out=${OUT:-build/benchmark_runs}/sets
mkdir -p "$out"
run() {
  python3 benchmark/run.py --workload "$cell" --seed "$2" --seconds "$secs" --trace "$3" \
      > "$out/$cell.$1.$2.out" 2> "$out/$cell.$1.$2.err"
  echo "$1 seed $2 trace $3 rc $? $(grep 'the check took' "$out/$cell.$1.$2.err")" \
       "$(tail -n 1 "$out/$cell.$1.$2.out")"
}
for set in A B; do
  for i in 1 2 3 4 5 6; do run "$set" $((s0 + i)) 0; done
done
for i in 7 8 9; do run T $((s0 + i)) 1; done
for i in 10 11 12; do run X $((s0 + i)) 0; done

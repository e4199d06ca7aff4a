# The runs that set a cell's bounds: two sets of 6 runs with the same seeds
# (PREFIX01..PREFIX06), then TRACED traced runs (PREFIX11.., 3 unless the
# environment sets TRACED), each a
# fresh process of perfbench/run.py at the benchmark's run_seconds, all in
# this one call. Each run's output goes to OUT/run-<cell>-<seed>-<trace>-
# <set>.out (.err), and OUT/rc.txt gets its exit code and wall time.
#
#   bash perfbench/tools/sets.sh OUT CELL:PREFIX [CELL:PREFIX ...]
O=$1; shift; mkdir -p "$O"
SECONDS_RUN=$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$O/card.txt" 2>&1
run() {
  s=$(date +%s%N)
  timeout 600 python3 perfbench/run.py --workload "$1" --seed "$2" \
    --seconds "$SECONDS_RUN" --trace "$3" > "$O/run-$1-$2-$3-$4.out" 2> "$O/run-$1-$2-$3-$4.err"
  rc=$?; e=$(date +%s%N)
  echo "$1 $2 trace=$3 set=$4 rc=$rc wall_ms=$(( (e - s) / 1000000 ))" >> "$O/rc.txt"
}
for c in "$@"; do
  cell=${c%:*}; p=${c#*:}
  for set in A B; do for k in 1 2 3 4 5 6; do run "$cell" "${p}0$k" 0 $set; done; done
  for k in $(seq 1 "${TRACED:-3}"); do run "$cell" "${p}1$k" 1 T; done
done
cat "$O/rc.txt"

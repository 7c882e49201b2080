#!/usr/bin/env bash
# The seed spread of the port's zoo ladder at emx's records' budgets on one
# CUDA card: small_ae and kernels (4000 steps) at seeds 1 and 2, and with
# --vaegan vaegan (16000 steps) at seed 1; scale 0.25, size 96. Seed 0 is
# scripts/run_port_zoo_ladder.sh's run (docs/runs/port_zoo_ladder*).
# Writes docs/runs/port_zoo_seeds/{seed1,seed2,vaegan_seed1}/quality.json
# (no rates: the processes share the card).
#
# Usage, from the repository root:  bash scripts/run_port_zoo_seeds.sh [--vaegan]
set -euo pipefail
logs=$(mktemp -d)
trap 'rm -rf "$logs"' EXIT
run() {   # dir steps families seed
  python -m emx_torch.bench.zoo_ladder "docs/runs/port_zoo_seeds/$1" "$2" \
    0.25 96 --families="$3" --seed="$4" --no-rates >> "$logs/$1.log" 2>&1
}
pids=()
run seed1 4000 small_ae,kernels 1 & pids+=($!)
run seed2 4000 small_ae,kernels 2 & pids+=($!)
if [[ "${1:-}" == "--vaegan" ]]; then
  run vaegan_seed1 16000 vaegan 1 & pids+=($!)
fi
status=0
for p in "${pids[@]}"; do wait "$p" || status=1; done
for f in "$logs"/*.log; do echo "== $f"; tail -n 3 "$f"; done
exit $status

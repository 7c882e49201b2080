#!/usr/bin/env bash
# The port's uncut zoo ladder on one CUDA card, at emx's records' budgets
# (docs/runs/zoo_ladder*/quality.json): scale 0.25, size 96; 4000 steps
# for the five families of docs/runs/zoo_ladder, 16000 for the _ext*
# files' families. Writes docs/runs/port_zoo_ladder{,_ext,_ext2,_ext3}/
# quality.json.
#
# Each eager step is host-bound, so the files' groups run as processes
# side by side on the card, one per output file. Their rates would be
# those of a shared card, so none is recorded (--no-rates); chip_smoke.py's
# zoo phase measures the rates, one process on the card.
#
# Usage, from the repository root:  bash scripts/run_port_zoo_ladder.sh
set -euo pipefail
logs=$(mktemp -d)
trap 'rm -rf "$logs"' EXIT
run() {   # dir steps families
  python -m emx_torch.bench.zoo_ladder "docs/runs/$1" "$2" 0.25 96 \
    --families="$3" --no-rates >> "$logs/$1.log" 2>&1
}
pids=()
{ run port_zoo_ladder 4000 small_ae,xception_ae,latent_ae,kernels,embedder &&
  run port_zoo_ladder_ext 16000 latent_ae,embedder; } & pids+=($!)
run port_zoo_ladder_ext2 16000 vaegan,manifold,vaegan_kl01,embedder_nce &
pids+=($!)
run port_zoo_ladder_ext3 16000 vaegan_anneal,vaegan_wass01 & pids+=($!)
status=0
for p in "${pids[@]}"; do wait "$p" || status=1; done
for f in "$logs"/*.log; do echo "== $f"; tail -n 3 "$f"; done
exit $status

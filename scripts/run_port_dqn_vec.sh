#!/usr/bin/env bash
# The port's vec DQN autofocus at emx's record's budget on one CUDA card:
# 999,936 env steps (7812 iterations of 128 lanes, two gradient steps an
# iteration after a 5000-transition warm-up), then the greedy evaluations.
# Writes docs/runs/port_dqn_vec/{quality.json,metrics.jsonl,log.txt,
# policy.npz} and compares them with docs/runs/dqn_autofocus (emx's run of
# the budget on a CPU) and the true-target rows of docs/runs/
# dqn_autofocus_v2; exits non-zero if a comparison fails.
#
# Usage, from the repository root:  bash scripts/run_port_dqn_vec.sh
set -euo pipefail
out=docs/runs/port_dqn_vec
rm -rf "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -m emx_torch.bench.dqn_vec "$out" 1000000 128
python -m emx_torch.bench.dqn_vec --compare "$out"

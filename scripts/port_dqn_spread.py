"""The port's six serial rows of the committed autofocus policy under
last-bit changes of its propagation: the port's own spread, beside emx's.

    python scripts/port_dqn_spread.py DEVICE SEEDS OUT.json
    python scripts/port_dqn_spread.py --summary RUNS.json [RUNS.json ...]

The first form evaluates docs/runs/dqn_autofocus_v2/policy.npz with
emx_torch.bench.dqn_vec.serial_eval on DEVICE (cuda or cpu) once per seed
in SEEDS (comma-separated). Seed 0 is the plain run; any other seed
scales each pixel of each propagated frame by 1 + 2^-23 k, k a whole
number drawn from N(0, 1.3) with that seed, as scripts/
make_port_dqn_trace.py --spread does to emx's. It writes {seed: rows}
to OUT.json and prints each run's dqn row (~11 s a run on an H100, ~12 s
on two CPU threads).

--summary prints, for each row and metric, the smallest, median and
largest value over the runs in the files (this script's output, or
docs/runs/port_dqn_eval/emx_nudged_rows.json).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
POLICY = os.path.join(ROOT, "docs/runs/dqn_autofocus_v2/policy.npz")


def port_rows(device: str, seeds: list[int]) -> dict:
    import torch

    import emx_torch.physics.propagate as prop
    from emx_torch.bench import dqn_vec
    from emx_torch.scope import dqn

    plain = prop.propagate_back_to_defocus
    _, agent = dqn_vec.make_trainer(0, 128, device)
    dqn.load_policy(agent, POLICY)
    out = {}
    try:
        for seed in seeds:
            rng = np.random.default_rng(seed)

            def nudged(*a, **k):
                o = plain(*a, **k)
                f = 1.0 + np.rint(rng.normal(0.0, 1.3, o.shape[-2:])) \
                    * 2.0 ** -23
                return o * torch.from_numpy(f.astype(np.float32)).to(
                    o.device)

            prop.propagate_back_to_defocus = nudged if seed else plain
            t0 = time.perf_counter()
            out[str(seed)] = dqn_vec.serial_eval(agent.q_values,
                                                 agent.shifts, 50, device)
            print(seed, f"{time.perf_counter() - t0:.1f} s",
                  json.dumps(out[str(seed)]["dqn"]), flush=True)
    finally:
        prop.propagate_back_to_defocus = plain
    return out


def span(runs: list[dict]) -> dict:
    """{row: {metric: (min, median, max)}} over a list of six-row runs."""
    return {row: {m: (float(np.min(v)), float(np.median(v)),
                      float(np.max(v)))
                  for m in runs[0][row]
                  for v in [[r[row][m] for r in runs]]}
            for row in runs[0]}


def main(argv: list[str]) -> None:
    if argv[0] == "--summary":
        runs = []
        for path in argv[1:]:
            with open(path) as f:
                data = json.load(f)
            runs += list(data.get("rows", data).values())
        print(f"{len(runs)} runs")
        for row, metrics in span(runs).items():
            for m, (lo, med, hi) in metrics.items():
                print(f"{row:22s} {m:25s} {lo:8.3f} {med:8.3f} {hi:8.3f}")
        return
    device, seeds, out = argv[0], [int(s) for s in argv[1].split(",")], \
        argv[2]
    if device == "cpu":
        import torch

        torch.set_num_threads(2)
    rows = port_rows(device, seeds)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, separators=(",", ":"))


if __name__ == "__main__":
    main(sys.argv[1:])

"""The zoo ladder's vaegan family, emx against the port, at a budget a CPU
can run: emx.bench.zoo_ladder.run_vaegan and emx_torch.bench.zoo_ladder.
run_vaegan at the same steps, scale, size and seed, both on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_vaegan_short.py emx 1000 0
    python scripts/port_vaegan_short.py port 1000 0
    python scripts/port_vaegan_short.py --summary

Each run writes docs/runs/port_zoo_vaegan_short/<side>_<steps>_seed<seed>
.json (the family's metrics, steps, scale, size, seconds, torch
threads). --summary prints, per budget, each seed's two PSNRs, their
difference and whether it lies within the zoo ladder's +-2.5 dB, and
each side's mean and span over its seeds, and writes summary.json there.
Scale 0.25 and size 96 are the records'; the records ran 16000 steps.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = "docs/runs/port_zoo_vaegan_short"
SCALE, SIZE = 0.25, 96
TOL_DB = 2.5          # the zoo ladder's tolerance on a PSNR


def run(side: str, steps: int, seed: int) -> dict:
    t0 = time.perf_counter()
    if side == "emx":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from emx.bench.zoo_ladder import run_vaegan

        r = run_vaegan(steps, SCALE, SIZE, seed=seed)
        threads = None
    elif side == "port":
        import torch

        from emx_torch.bench.zoo_ladder import run_vaegan

        r = run_vaegan(steps, SCALE, SIZE, seed=seed, device="cpu")
        threads = torch.get_num_threads()
    else:
        raise SystemExit(f"side must be emx or port, got {side!r}")
    out = {"side": side, "steps": steps, "scale": SCALE, "size": SIZE,
           "seed": seed, "seconds": round(time.perf_counter() - t0, 1),
           "torch_threads": threads, "vaegan": r}
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{side}_{steps}_seed{seed}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


def summary() -> dict:
    runs: dict = {}
    for path in sorted(glob.glob(os.path.join(OUT, "*_seed*.json"))):
        with open(path) as f:
            r = json.load(f)
        runs.setdefault((r["steps"], r["seed"]), {})[r["side"]] = r
    rows, spans = [], {}
    for (steps, seed), sides in sorted(runs.items()):
        for side, r in sides.items():
            spans.setdefault(f"{side}@{steps}", []).append(
                r["vaegan"]["psnr"])
        if set(sides) != {"emx", "port"}:
            continue
        e, p = sides["emx"]["vaegan"], sides["port"]["vaegan"]
        gap = round(p["psnr"] - e["psnr"], 2)
        rows.append({"steps": steps, "seed": seed, "emx_psnr": e["psnr"],
                     "port_psnr": p["psnr"],
                     "anchor_const_psnr": e["anchor_const_psnr"],
                     "port_minus_emx_db": gap,
                     "within_tol": abs(gap) <= TOL_DB,
                     "emx_top1": e["cutout_top1_retrieval"],
                     "port_top1": p["cutout_top1_retrieval"]})
    out = {"scale": SCALE, "size": SIZE, "tol_db": TOL_DB, "rows": rows,
           "spread": {k: {"n": len(v), "mean": round(sum(v) / len(v), 2),
                          "min": min(v), "max": max(v)}
                      for k, v in sorted(spans.items())}}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--summary"]:
        summary()
    else:
        run(args[0], int(args[1]), int(args[2]))

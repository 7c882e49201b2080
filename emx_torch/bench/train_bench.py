"""Training-step throughput ladder on the card (port of
emx/bench/train_bench.py).

    python -m emx_torch.bench.train_bench            # full ladder
    python -m emx_torch.bench.train_bench quick      # 4 rungs

emx's rungs (bf16 compute, rematerialised middle blocks, batch scaling,
norm choice) plus one the port adds: `steps_per_launch`, the train step
as a CUDA graph of K steps. Each rung times `steps` steps after one
(a graph rung: one launch) to warm up, ending in a read of the loss.
Prints one JSON line per rung, with the card's name and power limit.
Weights from a seed, data from numpy. Needs a CUDA card unless
`device="cpu"` is passed (rates from the CPU are not the card's).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from emx_torch.utils.device import card_name_and_power, resolve_device


def measure(s2d: int = 2, batch: int = 16, dtype: str = "bf16",
            remat: bool = False, norm: str = "group", steps: int = 16,
            size: int = 512, accum: int = 1, steps_per_launch: int = 1,
            config_overrides: dict | None = None,
            device: str | torch.device = "cuda") -> dict:
    from emx_torch.data.degrade import denoiser_example
    from emx_torch.nn import Denoiser, DenoiserConfig
    from emx_torch.train import TrainConfig, Trainer

    device = resolve_device(device)
    cfg = DenoiserConfig(
        norm=norm,
        dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
        space_to_depth=s2d, remat_middle=remat, **(config_overrides or {}))
    trainer = Trainer(
        Denoiser(cfg, device=device),
        TrainConfig(optimizer="nesterov", grad_accum=accum, log_every=0,
                    steps_per_launch=steps_per_launch),
        example_fn=denoiser_example)
    data = torch.from_numpy(np.random.default_rng(0).random(
        (batch, size, size), np.float32)).to(device)
    state = trainer.init()
    k = max(1, steps_per_launch)

    def run(n):   # n steps, in launches of k
        m = None
        for _ in range(n // k):
            if k > 1:
                m = trainer._launch(state, [data] * k)[-1, 0]
            else:
                m = trainer.step_fn(state, data)[1]["loss"]
        return float(m)   # a host read: the card has finished

    run(k)   # warm up (a graph rung: capture and one replay)
    t0 = time.perf_counter()
    loss = run(steps)
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return {"metric": "train_step_img_per_s",
            "value": round(batch * steps / dt, 2),
            "s2d": s2d, "batch": batch, "dtype": dtype, "remat": remat,
            "norm": norm, "accum": accum,
            "steps_per_launch": steps_per_launch, "loss": round(loss, 4),
            "device": (card_name_and_power() if device.type == "cuda"
                       else "cpu")}


LADDER = [
    dict(s2d=2, batch=16, dtype="f32"),                 # emx's baseline
    dict(s2d=2, batch=16, dtype="bf16"),
    dict(s2d=2, batch=32, dtype="bf16"),
    dict(s2d=2, batch=32, dtype="bf16", remat=True),
    dict(s2d=2, batch=64, dtype="bf16", remat=True),
    dict(s2d=2, batch=16, dtype="bf16", norm="none"),
    dict(s2d=4, batch=64, dtype="bf16"),
    dict(s2d=2, batch=16, dtype="bf16", steps_per_launch=8),
]

QUICK = [LADDER[0], LADDER[1], LADDER[3], LADDER[-1]]


def main(rungs, device: str | torch.device = "cuda") -> None:
    for kw in rungs:
        try:
            print(json.dumps(measure(**kw, device=device)), flush=True)
        except Exception as e:
            print(json.dumps({"error": str(e)[:200], **kw}), flush=True)


if __name__ == "__main__":
    main(QUICK if "quick" in sys.argv[1:] else LADDER)

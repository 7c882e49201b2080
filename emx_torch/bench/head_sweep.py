"""Inference throughput of the denoiser's head candidates (port of
emx/bench/head_sweep.py).

Each candidate is the flagship's body (s2d 4, norm none, bf16) with one
head, its weights drawn from a seed and held in bf16 on the card, timed
with emx's chain protocol: `chain` batches of 96 random 512x512 inputs
on the card, each chain ending in a read of the summed outputs; three
timings of two chains after one untimed chain, the median. Needs the
card.

Usage: python -m emx_torch.bench.head_sweep [out.jsonl]
Prints one JSON line per candidate and appends it to out.jsonl.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.nn.init import init_parameters
from emx_torch.utils.device import card_name_and_power, resolve_device

BASE = DenoiserConfig(norm="none", dtype=torch.bfloat16, space_to_depth=4)
CANDIDATES = (
    ("s2d4_plain", BASE),
    ("s2d4_mrh32", dataclasses.replace(BASE, mid_res_head=32)),
    ("s2d4_mrh48", dataclasses.replace(BASE, mid_res_head=48)),
    ("s2d4_mrh48_d3",
     dataclasses.replace(BASE, mid_res_head=48, mid_res_depth=3)),
    ("s2d4_mrh64", dataclasses.replace(BASE, mid_res_head=64)),
    ("s2d4_frh16", dataclasses.replace(BASE, full_res_head=16)),
)


def measure(name: str, cfg: DenoiserConfig, batch: int = 96,
            chain: int = 32, device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the head sweep is measured on the card")
    model = Denoiser(cfg, device=device)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(torch.bfloat16).eval().requires_grad_(False)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    xs = torch.rand((chain, batch, 512, 512), generator=gen, device=device,
                    dtype=torch.bfloat16)

    def run_chain() -> torch.Tensor:
        acc = torch.zeros((), device=device)
        with torch.inference_mode():
            for x in xs:
                acc = acc + model(x).float().sum()
        return acc

    t_c = time.perf_counter()
    float(run_chain())
    first_s = time.perf_counter() - t_c
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        total = sum(float(run_chain()) for _ in range(2))
        if total != total:
            raise AssertionError(f"{name}: non-finite output")
        rates.append(batch * chain * 2 / (time.perf_counter() - t0))
    out = {"variant": name, "img_per_s": round(sorted(rates)[1], 1),
           "groups": [round(r, 1) for r in rates],
           "first_chain_s": round(first_s, 1),
           "params_m": round(sum(p.numel() for p in model.parameters())
                             / 1e6, 2),
           "device": card_name_and_power()}
    print(json.dumps(out), flush=True)
    return out


def main(out_path: str = "runs/head_sweep/sweep.jsonl",
         device: str | torch.device = "cuda") -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "a") as f:
        for name, cfg in CANDIDATES:
            try:
                r = measure(name, cfg, device=device)
            except torch.cuda.OutOfMemoryError as e:
                # Keep sweeping past a variant that does not fit.
                r = {"variant": name, "error": str(e)[:200]}
                print(json.dumps(r), flush=True)
            f.write(json.dumps(r) + "\n")
            f.flush()


if __name__ == "__main__":
    main(*sys.argv[1:])

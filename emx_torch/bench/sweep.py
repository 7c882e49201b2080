"""Denoiser throughput sweep over architecture/batch variants (port of
emx/bench/sweep.py): the forward of the bf16 group-norm Denoiser at full
width on 512x512 inputs, parameters from flax's default distributions.

Usage: python -m emx_torch.bench.sweep [variant ...] [--device=cpu]
Variants: base16 base64 s2d2_16 s2d2_32 s2d2_64 s2d4_32 s2d4_64 s2d2_128
s2d4_128 s2d4_256 ref16 nonorm16 (default: base16 base64 s2d2_64).
Prints one JSON line per variant, with the card's name and power limit.
A launch is queued after the last without a host read; the clock stops
at one synchronise after the last (the accumulated sum is read then).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch


def variants() -> dict:
    """name -> (DenoiserConfig, batch), emx's table."""
    from emx_torch.nn import DenoiserConfig

    base = DenoiserConfig(norm="group", dtype=torch.bfloat16)

    def v(**kw):
        return dataclasses.replace(base, **kw)

    return {
        "base16": (base, 16),
        "base64": (base, 64),
        "s2d2_16": (v(space_to_depth=2), 16),
        "s2d2_32": (v(space_to_depth=2), 32),
        "s2d2_64": (v(space_to_depth=2), 64),
        "s2d4_32": (v(space_to_depth=4), 32),
        "s2d4_64": (v(space_to_depth=4), 64),
        "s2d2_128": (v(space_to_depth=2), 128),
        "s2d4_128": (v(space_to_depth=4), 128),
        "s2d4_256": (v(space_to_depth=4), 256),
        "ref16": (v(aspp_separable=False, upsample="transpose"), 16),
        "nonorm16": (v(norm="none"), 16),
    }


def measure(name: str, cfg, batch: int, n_iters: int = 30,
            size: int = 512, device="cuda") -> dict:
    """img/s and ms a launch of `n_iters` forwards (two inputs in turn)
    after one untimed first call, whose seconds are `first_call_s`."""
    from emx_torch.nn import Denoiser
    from emx_torch.nn.init import init_parameters
    from emx_torch.utils.device import card_name_and_power, resolve_device

    device = resolve_device(device)
    model = init_parameters(Denoiser(cfg, device=device),
                            torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.random((batch, size, size),
                                           np.float32)).to(device)
               for _ in range(2)]

    with torch.no_grad():
        t_first = time.perf_counter()
        float(model(batches[0]).float().sum())
        first_s = time.perf_counter() - t_first   # the read synchronised

        t0 = time.perf_counter()
        acc = torch.zeros((), device=device)
        for i in range(n_iters):
            acc = acc + model(batches[i % 2]).float().sum()
        total = float(acc)
        dt = time.perf_counter() - t0
    if not np.isfinite(total):
        raise FloatingPointError(f"{name}: the forwards' sum is {total}")
    out = {"variant": name, "batch": batch, "size": size,
           "img_per_s": round(batch * n_iters / dt, 2),
           "ms_per_launch": round(1000 * dt / n_iters, 2),
           "first_call_s": round(first_s, 1),
           "device": (card_name_and_power() if device.type == "cuda"
                      else "cpu")}
    print(json.dumps(out), flush=True)
    return out


def main(argv: list[str]) -> list[dict]:
    table = variants()
    dev = [x.split("=", 1)[1] for x in argv if x.startswith("--device=")]
    names = [x for x in argv if not x.startswith("-")] or [
        "base16", "base64", "s2d2_64"]
    out = []
    for n in names:
        cfg, b = table[n]
        try:
            out.append(measure(n, cfg, b, device=dev[-1] if dev else "cuda"))
        except Exception as e:
            out.append({"variant": n, "error": str(e)[:200]})
            print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

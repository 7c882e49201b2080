"""Times of a checkout's two CUDA kernels on the card.

    python -m emx_torch.bench.kernel_times [--tree DIR ...]

For each checkout DIR (default: this one), in the order given (list a
checkout again for another round, e.g. `--tree _parent . . _parent`):
K1 (`fused_sepconv`) at the six fused blocks of a flagship forward at
B=8 and at B=1, and K2 (`fused_poisson_degrade`) at the training
batch (16, 512, 512) and on (16, 512, 512) images of constant rate 5
(all below the CDF sampler's threshold of 10) and 200 (all above), with
each of its CUDA kernels alone (`phase_ms`) where the checkout has
`degrade_kernel.phase_calls`. Each time is taken twice: `device_ms`, with the
calls queued ahead of the card, and host-paced (CUDA events around calls
issued back to back). Each checkout runs in a process of its own, since
every checkout names its package `emx_torch`; this file imports nothing
of the package at its top, so it can time an older checkout. Inputs are
made from fixed seeds with numpy. Prints one JSON line per measurement
and one per checkout and batch with the sums. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

# (name, B, H, W, C, Co): the six fused SepConvBlocks of one flagship
# forward at a 512x512 tile (emx/nn/denoiser.py:235-236, 281-282,
# 294-295), as chip_smoke.py times them.
FLAGSHIP_BLOCKS = (("enc0.a", 128, 128, 16, 64), ("enc0.b", 128, 128, 64, 64),
                   ("refine.a", 128, 128, 128, 64),
                   ("refine.b", 128, 128, 64, 64),
                   ("folded.a", 128, 128, 80, 128),
                   ("folded.b", 128, 128, 128, 128))


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of `fn` on the card with the calls queued ahead:
    a sleep kernel holds the stream while the host queues the CUDA events
    and every call, so the card runs the calls back to back and never
    waits for the host (a call whose wrapper costs the host more than its
    kernel costs the card would otherwise time the host). The sleep grows
    until the host has queued everything before the card reaches the
    first event; `fn` must not synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 10_000_000                 # ~5 ms at the H100's clock
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("the host could not queue the calls ahead of the card")


def host_paced_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of `fn` on the card, by CUDA events around calls
    issued back to back: paced by the host where its share of a call is
    the larger."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sepconv_inputs(rng, b, h, w, c, co, device):
    """x in [0, 6) as bf16 NHWC, f32 depthwise and pointwise weights."""
    x = torch.from_numpy(rng.uniform(0.0, 6.0, (b, h, w, c)).astype(
        np.float32)).to(device, torch.bfloat16)
    arrs = (rng.normal(0, 0.3, (3, 3, 1, c)), rng.normal(0, 0.1, (c,)),
            rng.normal(0, 1 / np.sqrt(c), (1, 1, c, co)),
            rng.normal(0, 0.1, (co,)))
    return x, *(torch.from_numpy(a.astype(np.float32)).to(device)
                for a in arrs)


def measure(tree: str) -> None:
    """Time the kernels of the `emx_torch` on sys.path (the checkout)."""
    from emx_torch.data import synthetic_micrographs
    from emx_torch.ops.degrade_kernel import fused_poisson_degrade
    from emx_torch.ops.sepconv_kernel import fused_sepconv

    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    blocks = [(name, b, sepconv_inputs(rng, b, h, w, c, co, device))
              for b in (8, 1) for name, h, w, c, co in FLAGSHIP_BLOCKS]
    imgs = torch.from_numpy(synthetic_micrographs(16, 512, seed=1)).to(device)
    scales = torch.from_numpy((25.0 + 75.0 * rng.exponential(size=16)).astype(
        np.float32)).to(device)
    sums: dict[int, list[float]] = {8: [0.0, 0.0], 1: [0.0, 0.0]}
    for name, b, args in blocks:
        def k1():
            return fused_sepconv(*args, rows=32)
        ms, paced = device_ms(k1), host_paced_ms(k1)
        sums[b][0] += ms
        sums[b][1] += paced
        print(json.dumps({"tree": tree, "kernel": "K1", "block": name,
                          "batch": b, "ms": ms, "paced_ms": paced}),
              flush=True)
    for b, (ms, paced) in sums.items():
        print(json.dumps({"tree": tree, "kernel": "K1",
                          "block": "six flagship blocks", "batch": b,
                          "ms": ms, "paced_ms": paced}), flush=True)

    from emx_torch.ops import degrade_kernel
    k2_cases = [("training", imgs, scales)] + [
        (f"constant@{rate}", torch.ones((16, 512, 512), device=device),
         torch.full((16,), rate, device=device)) for rate in (5.0, 200.0)]
    for case, x, s in k2_cases:
        key = degrade_kernel.seed_tensor(7, device)

        def k2():
            return fused_poisson_degrade(key, x, s)
        row = {"tree": tree, "kernel": "K2", "case": case, "batch": 16,
               "ms": device_ms(k2), "paced_ms": host_paced_ms(k2)}
        # Each CUDA kernel of a call alone, where the checkout has them.
        if hasattr(degrade_kernel, "phase_calls"):
            row["phase_ms"] = {
                name: device_ms(fn) for name, fn in
                degrade_kernel.phase_calls(key, x, s).items()}
        print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", nargs="+", default=["."],
                    help="checkouts to time, in turns")
    ap.add_argument("--here", action="store_true",
                    help="time the emx_torch on sys.path (internal)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times measures the card: no CUDA device")
    if args.here:
        measure(args.tree[0])
        return
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()}), flush=True)
    for tree in args.tree:
        root = os.path.abspath(tree)
        env = {**os.environ, "PYTHONPATH": root}
        subprocess.run([sys.executable, os.path.abspath(__file__), "--here",
                        "--tree", tree],
                       cwd=root, env=env, check=True)


if __name__ == "__main__":
    main()

"""Where the time of one served forward goes, on the card.

    python -m emx_torch.bench.forward_profile [--bundle PATH] [--batch 1 8]

For the flagship int8 graph, unfused and with the fused SepConvBlocks,
at each batch size: the host-clock ms per forward (ending in a
synchronize), the device's busy ms (the sum of its kernels' times from
torch.profiler; one stream, so they do not overlap) and idle share, the
kernels run per forward and the host's launch calls (kernels and CUDA
graphs), and the kernels that take the most
device time. Prints one JSON line per (graph, batch). Inputs are made
from a seed with numpy. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from emx_torch.serve.artifact import load_denoiser_artifact
from emx_torch.serve.fused import fused_quantized_apply
from emx_torch.serve.quantize import quantized_apply
from emx_torch.utils.device import card_name_and_power


def profile_forward(fn, x: torch.Tensor, n: int = 5,
                    match: str | None = None) -> dict:
    """Profile n calls fn(x) after 3 warm-up calls; with `match`, also the
    device ms per call of the kernels whose name contains it."""
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name: dict[str, float] = defaultdict(float)
    launches = host = graphs = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n
            launches += 1
        elif e.name.startswith("cudaGraphLaunch"):
            graphs += 1
        elif e.name.startswith(("cudaLaunchKernel", "cudaLaunchCooperative")):
            host += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall_ms),
           "kernels_per_forward": launches / n,
           # The host's launch calls: kernels one by one, and graphs.
           "host_kernel_launches": host / n, "graph_launches": graphs / n,
           "top_kernels_ms": [[k[:90], round(v, 4)] for k, v in top]}
    if match is not None:
        out["matched_ms"] = sum(v for k, v in by_name.items() if match in k)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bundle", default="docs/runs/flagship/artifact_int8.npz")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--fused-rows", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("forward_profile measures the card: no CUDA device")
    device = torch.device("cuda", 0)
    card = card_name_and_power()
    _, model, quant = load_denoiser_artifact(args.bundle, with_quant=True,
                                             device=device)
    graphs = {
        "int8": quantized_apply(model, quant["amax"], quant["mode"],
                                skip=quant.get("skip", ())),
        "fused": fused_quantized_apply(model, quant["amax"], quant["mode"],
                                       skip=quant.get("skip", ()),
                                       rows=args.fused_rows),
    }
    rng = np.random.default_rng(0)
    for b in args.batch:
        x = torch.from_numpy(rng.random((b, args.tile, args.tile)).astype(
            np.float32)).to(device)
        for name, fn in graphs.items():
            res = profile_forward(fn, x)
            print(json.dumps({"graph": name, "batch": b, "tile": args.tile,
                              "card": card, **res}), flush=True)


if __name__ == "__main__":
    main()

"""Serving-graph sweep on the card (port of emx/bench/serve_perf.py).

Against one int8 bundle, at matched quality: the batch (64/96/128/192)
at the stored mode, then at the best batch the graph variants: output
in bfloat16, mode 'mxu2' (int8 depthwise; float32 and bfloat16 output),
fused SepConvBlocks on K1 at 32 and 64 rows, and the dense-folded
pairs in int8 and bf16. Each variant: img/s (the chain protocol of
emx_torch.bench.flagship_decision.throughput) and val-ladder PSNR.

Writes `out_dir`/serve_perf.json, and `out_dir`/serve_mode.json when a
fused or dense variant beats the best plain row at matched quality
(<= 0.02 dB below the stored mode). The sidecar is written only into
`out_dir`: serve_artifact reads it next to a bundle, so it takes effect
only if the caller places it there.

Usage: python -m emx_torch.bench.serve_perf OUT_DIR [bundle]
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from emx_torch.bench.flagship_decision import (FLAGSHIP, bundle_graph,
                                               file_sha256, throughput)
from emx_torch.bench.ladders import mean_psnr, val_ladder
from emx_torch.utils.device import card_name_and_power, resolve_device

BATCHES = (64, 96, 128, 192)


def variants(base_mode: str, batch: int) -> list[tuple[str, dict]]:
    """(tag, bundle_graph keywords) of the graph variants, tagged as
    emx's serve_perf.json tags them."""
    return [
        (f"{base_mode}/out_bfloat16/b{batch}", {"out_dtype": "bfloat16"}),
        (f"mxu2/out_float32/b{batch}", {"mode": "mxu2"}),
        (f"mxu2/out_bfloat16/b{batch}", {"mode": "mxu2",
                                         "out_dtype": "bfloat16"}),
        (f"{base_mode}/fused_r32/b{batch}", {"fused_rows": 32}),
        (f"{base_mode}/fused_r64/b{batch}", {"fused_rows": 64}),
        (f"{base_mode}/dense_int8/b{batch}", {"dense": "int8"}),
        (f"{base_mode}/dense_bf16/b{batch}", {"dense": "bf16"}),
    ]


def main(out_dir: str, bundle: str = FLAGSHIP,
         device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    base, base_mode = bundle_graph(bundle, device)
    if base_mode == "float":
        raise ValueError("the sweep needs an int8-promoted bundle")
    noisy, clean = val_ladder(device)

    def stage(msg):
        print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)

    rows = []
    for b in BATCHES:
        r = throughput(base, device, batch=b)
        rows.append({"variant": f"{base_mode}/b{b}", "img_per_s": r})
        stage(f"{base_mode}/b{b}: {r:.1f} img/s")
    best_b = int(max(rows, key=lambda r: r["img_per_s"])["variant"]
                 .split("/b")[-1])
    for tag, kw in variants(base_mode, best_b):
        fn, _ = bundle_graph(bundle, device, **kw)
        psnr = mean_psnr(fn(noisy).float(), clean)
        r = throughput(fn, device, batch=best_b)
        rows.append({"variant": tag, "img_per_s": r, "psnr": psnr})
        stage(f"{tag}: {r:.1f} img/s @ {psnr} dB")
        del fn
    base_psnr = mean_psnr(base(noisy).float(), clean)
    out = {"metric": "serve_perf_sweep", "bundle": bundle,
           "device": card_name_and_power(), "stored_mode": base_mode,
           "base_psnr": base_psnr, "best_batch": best_b, "rows": rows}

    def is_alt(r):
        return "/fused_r" in r["variant"] or "/dense_" in r["variant"]

    plain = [r for r in rows if not is_alt(r)]
    alts = [r for r in rows if is_alt(r)
            and r.get("psnr", 0.0) >= base_psnr - 0.02]
    best_u = max(plain, key=lambda r: r["img_per_s"])
    best_f = max(alts, key=lambda r: r["img_per_s"]) if alts else None
    os.makedirs(out_dir, exist_ok=True)
    if best_f is not None and best_f["img_per_s"] > best_u["img_per_s"]:
        sha = file_sha256(bundle)[:12]
        tag = best_f["variant"]
        choice = ({"fused_rows": int(tag.split("fused_r")[1].split("/")[0])}
                  if "/fused_r" in tag else
                  {"dense": tag.split("/dense_")[1].split("/")[0]})
        with open(os.path.join(out_dir, "serve_mode.json"), "w") as f:
            json.dump({**choice, "bundle_sha": sha,
                       "img_per_s": best_f["img_per_s"],
                       "psnr": best_f.get("psnr"),
                       "unfused_img_per_s": best_u["img_per_s"],
                       "base_psnr": base_psnr}, f, indent=1)
        out["serve_mode_promoted"] = choice
    with open(os.path.join(out_dir, "serve_perf.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], a[1] if len(a) > 1 else FLAGSHIP)

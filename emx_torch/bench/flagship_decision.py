"""Score deployment bundles on the flagship's five ladders, as emx's
flagship decision does (port of emx/bench/flagship_decision.py).

Each candidate bundle is scored on every family of `FAMILIES`: the NN's
PSNR, the best classical filter (emx_torch.analysis.filters, identity
included, as emx counts it), the margin over it, and the identity PSNR;
plus its serving rate at batch 96 on the card. `select_winner` is emx's
policy: hard gates, then the highest sum of per-family margins each
capped at +1 dB, ties within 0.1 dB by val PSNR.

This port writes its DECISION.json to the `out_dir` it is given and
never writes under docs/runs/flagship/ nor promotes a bundle: the
flagship path has one writer, emx's flagship_decision.

Usage: python -m emx_torch.bench.flagship_decision OUT_DIR [bundle ...]
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time

import torch

from emx_torch.analysis.filters import compare_denoisers
from emx_torch.bench.ladders import FAMILIES, load_ladder, mean_psnr
from emx_torch.nn.denoiser import Denoiser
from emx_torch.serve.artifact import read_artifact
from emx_torch.serve.convert import load_flax_params
from emx_torch.serve.fused import build_graph
from emx_torch.utils.device import card_name_and_power, resolve_device

FLAGSHIP = "docs/runs/flagship/artifact_int8.npz"
PSNR_GATE = 36.01258850097656   # emx's classical bar on the val ladder


def file_sha256(path: str, n: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(n):
            h.update(chunk)
    return h.hexdigest()


def all_ladders(device: str | torch.device = "cuda", families=FAMILIES
                ) -> dict:
    return {f: load_ladder(f, device) for f in families}


def family_rows(nn_fn, ladders: dict) -> dict:
    """Per family: the NN's PSNR on its ladder, the best classical filter
    and the margin over it, and the identity PSNR."""
    rows = {}
    for fam, (noisy, clean) in ladders.items():
        res = compare_denoisers(noisy, clean, nn_fn=nn_fn)
        classical = {k: round(v["psnr"], 3) for k, v in res.items()
                     if k != "nn"}
        best = max(classical.items(), key=lambda kv: kv[1])
        nn = round(res["nn"]["psnr"], 3)
        rows[fam] = {"nn_psnr": nn, "best_classical": list(best),
                     "margin": round(nn - best[1], 3),
                     "identity_psnr": mean_psnr(noisy, clean)}
    return rows


def capped_margin_sum(rows: dict, cap_db: float = 1.0) -> float:
    return round(sum(min(rows[f]["margin"], cap_db) for f in rows), 3)


def throughput(apply_fn, device: torch.device, batch: int = 96,
               chain: int = 16) -> float:
    """img/s of `apply_fn` on (batch, 512, 512) float32 inputs in [0, 1]:
    three timings of two passes over `chain` batches, each ending in a
    read of the summed outputs, after one untimed pass (emx's chain
    protocol); the median. Needs the card."""
    if device.type != "cuda":
        raise RuntimeError("throughput is measured on the card")
    reps, trials = 2, 3
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    xs = torch.rand((chain, batch, 512, 512), generator=gen, device=device)

    def run():
        acc = torch.zeros((), device=device)
        for x in xs:
            acc = acc + apply_fn(x).float().sum()
        return acc

    float(run())
    rates = []
    for _ in range(trials):
        t0 = time.perf_counter()
        acc = sum(float(run()) for _ in range(reps))
        if acc != acc:
            raise AssertionError("non-finite serving output")
        rates.append(batch * chain * reps / (time.perf_counter() - t0))
    return sorted(rates)[trials // 2]


def bundle_graph(bundle: str, device: str | torch.device = "cuda",
                 fused_rows: int = 0,
                 mode: str | None = None, out_dtype: str | None = None,
                 dense: str = ""):
    """The bundle's serving graph and its mode: int8 as its recipe says
    (`mode` overrides it), fused at `fused_rows` or dense-folded (`dense`
    "int8" or "bf16"), with the model's output in `out_dtype` (default:
    the bundle's); or the float model."""
    device = resolve_device(device)
    cfg, flat, quant = read_artifact(bundle)
    if out_dtype is not None:
        cfg = dataclasses.replace(cfg, out_dtype=out_dtype)
    model = load_flax_params(Denoiser(cfg, device="cpu"), flat)
    model = model.to(device).eval().requires_grad_(False)
    if quant is None:
        if mode or fused_rows or dense:
            raise ValueError(f"{bundle} is not int8-promoted")

        def graph(x):
            with torch.inference_mode():
                return model(x)
        return graph, "float"
    return (build_graph(model, quant, mode, fused_rows, dense),
            mode or quant["mode"])


def score_bundle(bundle: str, ladders: dict,
                 device: str | torch.device = "cuda") -> dict:
    """The bundle's DECISION row (its unfused graph, the program emx's
    DECISION scores): per-family rows, img/s at batch 96 on the card,
    the capped margin sum and the worst margin."""
    device = resolve_device(device)
    nn_fn, mode = bundle_graph(bundle, device)
    row = {"bundle": bundle, "sha256": file_sha256(bundle), "quant_mode": mode}
    row.update(family_rows(nn_fn, ladders))
    row["img_per_s"] = throughput(nn_fn, device)
    row["capped_margin_sum"] = capped_margin_sum(
        {f: row[f] for f in ladders})
    row["worst_margin"] = min(row[f]["margin"] for f in ladders)
    return row


def select_winner(rows: list[dict], psnr_gate: float, rate_gate: float,
                  families=("val", "ood_ctf", "ood_grains"),
                  cap_db: float = 1.0):
    """emx's policy: hard gates, then the highest sum of per-family
    classical margins, each capped at +`cap_db`; ties (within 0.1 dB)
    break by val PSNR. Returns the winning row or None."""
    def eligible(r):
        return (r["val"]["nn_psnr"] >= psnr_gate
                and r["img_per_s"] >= rate_gate)

    def score(r):
        return sum(min(r[f]["margin"], cap_db) for f in families)

    passing = [r for r in rows if eligible(r)]
    if not passing:
        return None
    best = max(score(r) for r in passing)
    near = [r for r in passing if score(r) >= best - 0.1]
    return max(near, key=lambda r: r["val"]["nn_psnr"])


def main(out_dir: str, candidates: list[str] | None = None,
         psnr_gate: float = PSNR_GATE, rate_gate: float = 0.0,
         device: str | torch.device = "cuda") -> dict:
    """Score `candidates` (default: the flagship bundle) and write
    `out_dir`/DECISION.json. `rate_gate` defaults to 0: emx's 5000 img/s
    gate is a TPU's rate, not the card's."""
    flag_dir = os.path.abspath(os.path.dirname(FLAGSHIP))
    if os.path.commonpath([os.path.abspath(out_dir), flag_dir]) == flag_dir:
        raise ValueError("the port never writes under docs/runs/flagship/")
    device = resolve_device(device)
    candidates = candidates or [FLAGSHIP]
    ladders = all_ladders(device)
    rows = [score_bundle(b, ladders, device) for b in candidates]
    win = select_winner(rows, psnr_gate, rate_gate, families=FAMILIES)
    out = {"metric": "flagship_decision", "device": card_name_and_power(),
           "policy": "gates(val>=psnr_gate, >=rate_gate img/s) then "
                     "highest sum of per-family margins over best "
                     "classical, each capped at +1 dB, ties by val PSNR",
           "winner": win["bundle"] if win else None,
           "winner_capped_margin_sum": (win["capped_margin_sum"]
                                        if win else None),
           "candidates": rows}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "DECISION.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:] or None)

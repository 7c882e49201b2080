"""Quantized-deployment check: PSNR and throughput of the int8 modes
against the float bundle (port of emx/bench/quant_check.py).

  * `main` scores the float graph and the 'store' and 'mxu' graphs on
    the val ladder, times them at batch 96 on the card, and with a
    `psnr_gate` skips the most damaging conv groups until a mode passes,
    then promotes the fastest passing mode into a candidate bundle;
  * `calib_independence` recalibrates a promoted bundle on training
    degradations (disjoint from the ladder) and re-scores the ladder;
  * `ood_check` scores a bundle, its float twin and the classical
    filters on an out-of-family ladder.

The ladders are the committed ones (emx_torch.bench.ladders); the
throughput is flagship_decision.throughput, emx's chain protocol, which
needs the card: on the CPU each rate is recorded as an error, as emx
records a failed timing. Unlike emx, a promoted candidate always goes to
`out_dir`/bundle.npz, never beside the bundle it came from, and the
defaults write under runs/, not docs/runs/.

Usage: python -m emx_torch.bench.quant_check <artifact.npz> [out_dir]
           [psnr_gate]
       python -m emx_torch.bench.quant_check calib [bundle] [out_dir]
       python -m emx_torch.bench.quant_check ood [bundle] [out_dir] [family]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

from emx_torch.analysis.filters import compare_denoisers
from emx_torch.bench import flagship_decision
from emx_torch.bench.flagship_decision import FLAGSHIP
from emx_torch.bench.ladders import mean_psnr, ood_ladder, val_ladder
from emx_torch.data.degrade import denoiser_example
from emx_torch.data.pipeline import synthetic_micrographs
from emx_torch.nn.denoiser import Denoiser
from emx_torch.serve.artifact import read_artifact, save_denoiser_artifact
from emx_torch.serve.convert import load_flax_params
from emx_torch.serve.quantize import calibrate, quantized_apply
from emx_torch.utils.device import resolve_device

# The val ladder's best classical filter (gaussian), emx's bar.
VAL_CLASSICAL_BAR = 36.01258850097656


def deployment_model(artifact: str, device: str | torch.device = "cuda"):
    """(config in bf16, flat float32 params, the Denoiser on `device` in
    eval mode without gradients), as emx's scripts load a bundle."""
    device = resolve_device(device)
    cfg, flat, _ = read_artifact(artifact)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    model = load_flax_params(Denoiser(cfg, device="cpu"), flat)
    return cfg, flat, model.to(device).eval().requires_grad_(False)


def float_apply(model: torch.nn.Module):
    def fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)
    return fn


def incumbent_psnr(path: str = FLAGSHIP) -> float:
    """The val PSNR a promoted bundle records, -1 if there is none."""
    if not os.path.exists(path):
        return -1.0
    return float((read_artifact(path)[2] or {}).get("psnr", -1.0))


def write_record(out: dict, out_dir: str, name: str) -> dict:
    """Write `out` as `out_dir`/`name` (JSON) and print it on one line."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


def main(artifact: str, out_dir: str = "runs/quant_check",
         throughput: bool = True, psnr_gate: float | None = None,
         device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    cfg, flat, model = deployment_model(artifact, device)
    noisy, clean = val_ladder(device)
    float_fn = float_apply(model)
    # Calibrate on a slice of the ladder inputs (the served regime).
    amax = calibrate(model, [noisy[:8]])
    out: dict = {"metric": "quant_check", "artifact": artifact,
                 "float_psnr": mean_psnr(float_fn(noisy), clean)}
    fns = {"float": float_fn}
    skips: dict[str, tuple] = {}
    for mode in ("store", "mxu"):
        fn = quantized_apply(model, amax, mode=mode)
        out[f"{mode}_psnr"] = mean_psnr(fn(noisy), clean)
        fns[mode] = fn
        skips[mode] = ()

    # Sensitivity-guided repair: rank conv groups (top-level modules) by
    # the damage of quantizing that group alone, then skip the most
    # damaging groups until the gate passes.
    if psnr_gate is not None:
        groups = sorted({p.split("/")[0] for p in amax})
        for mode in ("mxu", "store"):
            if out[f"{mode}_psnr"] >= psnr_gate:
                continue
            damage = {}
            for g in groups:
                only_g = [p for p in amax if not p.startswith(g + "/")
                          and p != g]
                fn_g = quantized_apply(model, amax, mode=mode, skip=only_g)
                damage[g] = out["float_psnr"] - mean_psnr(fn_g(noisy), clean)
            ranked = sorted(damage.items(), key=lambda kv: -kv[1])
            out[f"{mode}_group_damage"] = {g: round(d, 3) for g, d in ranked}
            skip: list[str] = []
            for g, _ in ranked:
                skip += [p for p in amax if p.startswith(g + "/") or p == g]
                fn_s = quantized_apply(model, amax, mode=mode, skip=skip)
                p_s = mean_psnr(fn_s(noisy), clean)
                if p_s >= psnr_gate:
                    out[f"{mode}_psnr"] = p_s
                    out[f"{mode}_skip_groups"] = sorted(
                        {s.split("/")[0] for s in skip})
                    fns[mode] = fn_s
                    skips[mode] = tuple(skip)
                    break
    if throughput:
        for name, fn in fns.items():
            try:
                out[f"{name}_img_per_s"] = round(
                    flagship_decision.throughput(fn, device), 1)
            except RuntimeError as e:          # no card: emx records it
                out[f"{name}_throughput_error"] = str(e)[:200]
    # Promotion: the fastest quantized mode that clears the gate and
    # beats the float graph's rate.
    if psnr_gate is not None:
        float_tp = out.get("float_img_per_s", float("inf"))
        best = None
        for mode in ("mxu", "store"):
            p, t = out.get(f"{mode}_psnr"), out.get(f"{mode}_img_per_s")
            if p is None or t is None or p < psnr_gate or t <= float_tp:
                continue
            if best is None or t > out[f"{best}_img_per_s"]:
                best = mode
        out["psnr_gate"] = psnr_gate
        out["promoted_mode"] = best
        dest = os.path.join(out_dir, "bundle.npz")
        if best is not None and os.path.exists(dest):
            # Never regress an existing promoted candidate.
            out["incumbent_psnr"] = incumbent_psnr(dest)
            if out[f"{best}_psnr"] <= out["incumbent_psnr"]:
                best = out["promoted_mode"] = None
        if best is not None:
            os.makedirs(out_dir, exist_ok=True)
            save_denoiser_artifact(dest, cfg, {"params": flat}, quant={
                "mode": best, "amax": amax,
                "skip": list(skips.get(best, ())),
                "psnr": out[f"{best}_psnr"],
                "float_psnr": out["float_psnr"],
                "psnr_gate": psnr_gate,
                "img_per_s_at_check": out[f"{best}_img_per_s"]})
            out["promoted_artifact"] = dest
    return write_record(out, out_dir, "quant_check.json")


def calib_independence(bundle: str = FLAGSHIP,
                       out_dir: str = "runs/quant_check",
                       device: str | torch.device = "cuda") -> dict:
    """Evidence that a promoted bundle's PSNR does not hinge on
    calibrating with val-ladder inputs: recalibrate on training-corpus
    degradations (synthetic seed 0, disjoint from the ladder's 999) and
    score the ladder with those scales."""
    device = resolve_device(device)
    _, _, quant = read_artifact(bundle)
    if quant is None:
        raise ValueError(f"{bundle} has no promoted quant mode")
    _, _, model = deployment_model(bundle, device)
    noisy, clean = val_ladder(device)
    skip = quant.get("skip", ())
    out = {"metric": "calib_independence", "bundle": bundle,
           "mode": quant["mode"]}
    out["ladder_calib_psnr"] = mean_psnr(quantized_apply(
        model, quant["amax"], quant["mode"], skip=skip)(noisy), clean)
    imgs = torch.from_numpy(synthetic_micrographs(
        8, noisy.shape[-1], seed=0)).to(device)
    lq, _ = denoiser_example(11, imgs)
    amax_train = calibrate(model, [lq])
    out["train_calib_psnr"] = mean_psnr(quantized_apply(
        model, amax_train, quant["mode"], skip=skip)(noisy), clean)
    out["delta_db"] = round(out["ladder_calib_psnr"]
                            - out["train_calib_psnr"], 3)
    return write_record(out, out_dir, "calib_independence.json")


_FAMILY_NAMES = {"grains": "grain_micrographs",
                 "filaments": "filament_micrographs",
                 "porous": "porous_micrographs"}


def ood_check(bundle: str = FLAGSHIP, out_dir: str = "runs/quant_check",
              family: str = "ctf",
              device: str | torch.device = "cuda") -> dict:
    """A bundle (its served int8 graph, or the float one if it has no
    quant mode), its float twin and every classical filter on the
    `family` ladder ("ctf", "grains", "filaments" or "porous"). Writes
    ood_check.json (ctf) or ood_check_<family>.json."""
    device = resolve_device(device)
    _, _, quant = read_artifact(bundle)
    _, _, model = deployment_model(bundle, device)
    noisy, clean = ood_ladder(family, device)
    nn_fn = (quantized_apply(model, quant["amax"], quant["mode"],
                             skip=quant.get("skip", ()))
             if quant is not None else float_apply(model))
    results = compare_denoisers(noisy, clean, nn_fn=nn_fn)
    classical = {k: round(v["psnr"], 3) for k, v in results.items()
                 if k != "nn"}
    best = max(classical.items(), key=lambda kv: kv[1])
    nn_psnr = round(results["nn"]["psnr"], 3)
    out = {"metric": "ood_check", "bundle": bundle,
           "family": _FAMILY_NAMES.get(family, "ctf_micrographs"),
           "quant_mode": (quant or {}).get("mode", "float"),
           "nn_psnr": nn_psnr,
           "nn_float_psnr": mean_psnr(float_apply(model)(noisy), clean),
           "identity_psnr": mean_psnr(noisy, clean),
           "best_classical": list(best), "all": {**classical, "nn": nn_psnr}}
    name = ("ood_check.json" if family == "ctf"
            else f"ood_check_{family}.json")
    return write_record(out, out_dir, name)


if __name__ == "__main__":
    a = sys.argv[1:]
    if a and a[0] == "calib":
        calib_independence(*a[1:])
    elif a and a[0] == "ood":
        ood_check(*a[1:])
    else:
        main(a[0] if a else "docs/runs/flagship/artifact.npz",
             a[1] if len(a) > 1 else "runs/quant_check",
             psnr_gate=float(a[2]) if len(a) > 2 else None)

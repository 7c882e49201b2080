"""Auto-select (J-invariant) quality on every ladder (port of
emx/bench/auto_select_check.py).

Per family of the flagship ladders: the PSNR of each serving candidate
(emx_torch.serve.select.serving_candidates: the bundle's int8 graph and
the gaussian, median, wiener and TV filters), the PSNR of
`auto_denoise` choosing per image on the noisy frame alone, the best
classical PSNR of the full six-filter ladder, both margins over it, and
how often each candidate was chosen. Writes `out_path`.

Usage: python -m emx_torch.bench.auto_select_check OUT_PATH [bundle]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from emx_torch.analysis.filters import compare_denoisers
from emx_torch.bench.flagship_decision import FLAGSHIP, bundle_graph
from emx_torch.bench.ladders import FAMILIES, load_ladder, mean_psnr
from emx_torch.serve.select import auto_denoise, serving_candidates
from emx_torch.utils.device import card_name_and_power, resolve_device


def family_row(noisy: torch.Tensor, clean: torch.Tensor, names, cands,
               seed: int = 7, n_masks: int = 4) -> dict:
    with torch.inference_mode():
        per = {n: mean_psnr(fn(noisy), clean) for n, fn in zip(names, cands)}
    res = compare_denoisers(noisy, clean)
    best = round(max(v["psnr"] for k, v in res.items() if k != "identity"),
                 3)
    out, chosen = auto_denoise(noisy, cands, seed, n_masks=n_masks)
    auto = mean_psnr(out, clean)
    counts = np.bincount(chosen.cpu().numpy(), minlength=len(names))
    return {"per_candidate_psnr": per, "auto_psnr": auto,
            "best_classical_psnr": best,
            "auto_margin": round(auto - best, 3),
            "nn_margin": round(per["nn"] - best, 3),
            "chosen_counts": dict(zip(names, counts.tolist()))}


def main(out_path: str, bundle: str = FLAGSHIP,
         device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    nn_fn, _ = bundle_graph(bundle, device)
    names, cands = serving_candidates(nn_fn)
    rows = {}
    for fam in FAMILIES:
        noisy, clean = load_ladder(fam, device)
        rows[fam] = family_row(noisy, clean, names, cands)
        print(fam, json.dumps(rows[fam]), flush=True)
    out = {"metric": "auto_select_check", "bundle": bundle,
           "device": card_name_and_power(), "n_masks": 4,
           "families": rows,
           "worst_auto_margin": min(r["auto_margin"] for r in rows.values()),
           "worst_nn_margin": min(r["nn_margin"] for r in rows.values())}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], a[1] if len(a) > 1 else FLAGSHIP)

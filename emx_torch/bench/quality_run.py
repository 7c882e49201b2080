"""Production-width quality anchoring (port of emx/bench/quality_run.py).

Trains the flagship denoiser at full width on the card for `steps`
steps, then scores it on the val ladder against the six classical
filters (the reference's err_hist workload), folds a BatchNorm model
into its deployment bundle (`artifact.npz`) and scores the folded model
too, and adds the out-of-family row (the ctf ladder). The flagship's own
run: s2d 4, norm 'batch', folded head 128, corpus 'mixed3', 60000 steps
(docs/runs/quality_r5/quality.json).

The schedule is emx's: nesterov 1e-3 for the first 70% of the steps,
then 1e-4, set on the optimizer between segments of at most 5000 steps;
a checkpoint every 1000 steps and `state_bn.npz` (parameters and batch
statistics, emx's keys) after each segment. A run resumes from its
latest checkpoint, or starts from `init_from` (a state_bn.npz) with a
fresh optimizer.

Port additions to emx's API: `corpus_size` (emx's 1024 by default),
`log_every` (emx's 50) and `device`. The ladders are the committed ones
(emx_torch.bench.ladders).

Usage: python -m emx_torch.bench.quality_run <out_dir> [s2d] [steps]
           [batch] [full_res_head] [norm] [mid_res_head] [folded_head]
           [init_from|none] [corpus]
Writes <out_dir>/metrics.jsonl, checkpoints, state_bn.npz, err_hist/,
artifact.npz (BatchNorm models) and quality.json; prints the summary as
one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from emx_torch.analysis.filters import compare_denoisers, save_err_hists
from emx_torch.bench.ladders import mean_psnr, ood_ladder, val_ladder
from emx_torch.bench.qat_finetune import training_corpus
from emx_torch.bench.quant_check import float_apply
from emx_torch.data import DeviceDataset, PipelineConfig, denoiser_example
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.serve.artifact import (load_pytree_like, save_denoiser_artifact,
                                      save_pytree_npz)
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.serve.optimize import fold_denoiser
from emx_torch.train import (Checkpointer, TrainConfig, Trainer,
                             set_learning_rate)
from emx_torch.utils.device import resolve_device

# The body's widths and depth (the flagship's, DenoiserConfig's
# defaults) and the training tile; the CPU tests shrink both.
MODEL = DenoiserConfig()
SIZE = 512
SAVE_EVERY = 5000


def main(out_dir: str, s2d: int = 2, steps: int = 5000, batch: int = 16,
         full_res_head: int = 0, norm: str = "group",
         mid_res_head: int = 0, folded_head: int = 0,
         init_from: str | None = None, corpus: str = "synthetic",
         corpus_size: int = 1024, log_every: int = 50,
         device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg = dataclasses.replace(
        MODEL, norm=norm, dtype=torch.bfloat16, space_to_depth=s2d,
        remat_middle=True, full_res_head=full_res_head,
        mid_res_head=mid_res_head, folded_head=folded_head)
    model = Denoiser(cfg, device=device)
    # The reference's hyperparameters: nesterov momentum 0.9, lr 1e-3.
    tcfg = TrainConfig(learning_rate=1e-3, optimizer="nesterov",
                       grad_clip_norm=0.0, log_every=log_every,
                       ckpt_every_steps=1000, model_dir=out_dir, seed=0)
    trainer = Trainer(model, tcfg, example_fn=denoiser_example)
    train_imgs = training_corpus(corpus, corpus_size, SIZE, device)
    pipe = DeviceDataset(train_imgs,
                         PipelineConfig(batch_size=batch, crop_size=SIZE),
                         device=device)
    state = trainer.init()
    ckpt = Checkpointer(os.path.join(out_dir, "ckpt"))
    if ckpt.latest_step() is not None:
        # Resume an interrupted run (step, optimizer, pipeline cursor).
        state, pipe_state = ckpt.restore(state)
        if pipe_state:
            pipe.load_state_dict(pipe_state)
    elif init_from:
        # Warm start from a state_bn.npz; the optimizer starts fresh.
        params, stats = to_flax_params(model)
        ref = {"params": params}
        if stats:
            ref["batch_stats"] = stats
        tree, meta = load_pytree_like(init_from, ref)
        load_flax_params(model, tree["params"], tree.get("batch_stats"))
        state.step = int(meta.get("step", 0))

    def save_resume():
        params, stats = to_flax_params(model)
        bundle = {"params": params}
        if stats:
            bundle["batch_stats"] = stats
        save_pytree_npz(os.path.join(out_dir, "state_bn.npz"), bundle,
                        meta={"step": state.step, "s2d": s2d, "norm": norm,
                              "folded_head": folded_head})

    start = state.step
    t0 = time.perf_counter()
    # Two phases: 1e-3 for the first 70% of the steps, then 1e-4.
    phase1 = int(steps * 0.7)
    while state.step < steps:
        here = state.step
        if here >= phase1:
            set_learning_rate(state.optimizer, 1e-4)
        bound = phase1 if here < phase1 else steps
        state = trainer.fit(state, pipe,
                            num_steps=min(bound, here + SAVE_EVERY),
                            checkpointer=ckpt)
        save_resume()
    train_s = max(time.perf_counter() - t0, 1e-9)
    ckpt.save(state.step, state, pipe.state_dict(), wait=True)
    ckpt.close()
    save_resume()

    # The fixed low-dose val ladder: the regime the denoiser exists for.
    noisy, clean = val_ladder(device)
    model.eval()
    nn_fn = float_apply(model)
    results = compare_denoisers(noisy, clean, nn_fn=nn_fn, per_image=True)

    folded_psnr = None
    if norm == "batch":
        # Fold BatchNorm into the convs and score the folded model (the
        # graph that is served); the fold is exact at inference.
        folded_cfg, folded_params = fold_denoiser(cfg, *to_flax_params(model))
        folded = load_flax_params(Denoiser(folded_cfg, device="cpu"),
                                  folded_params)
        folded = folded.to(device).eval().requires_grad_(False)
        folded_psnr = float(mean_psnr(float_apply(folded)(noisy), clean))
        save_denoiser_artifact(os.path.join(out_dir, "artifact.npz"),
                               folded_cfg, {"params": folded_params})

    save_err_hists(results, os.path.join(out_dir, "err_hist"))
    results = {k: {m: v for m, v in r.items() if m in ("mse", "psnr")}
               for k, r in results.items()}
    # Out-of-family row (the ctf ladder), reported for every run.
    ood_noisy, ood_clean = ood_ladder("ctf", device)
    ood_psnr = mean_psnr(nn_fn(ood_noisy), ood_clean)

    summary = {
        "metric": "quality_anchor", "corpus": corpus,
        "ood_psnr": ood_psnr,
        "s2d": s2d, "steps": state.step, "batch": batch,
        "full_res_head": full_res_head, "mid_res_head": mid_res_head,
        "folded_head": folded_head, "norm": norm,
        "train_img_per_s": round(batch * (state.step - start) / train_s, 2),
        "nn_psnr": round(results["nn"]["psnr"], 3),
        "identity_psnr": round(results["identity"]["psnr"], 3),
        "best_classical": max(
            ((k, v["psnr"]) for k, v in results.items()
             if k not in ("nn", "identity")), key=lambda kv: kv[1]),
        "all": {k: round(v["psnr"], 3) for k, v in results.items()},
    }
    if folded_psnr is not None:
        summary["nn_folded_psnr"] = round(folded_psnr, 3)
    with open(os.path.join(out_dir, "quality.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0] if a else "runs/quality_s2d2",
         int(a[1]) if len(a) > 1 else 2,
         int(a[2]) if len(a) > 2 else 5000,
         int(a[3]) if len(a) > 3 else 16,
         int(a[4]) if len(a) > 4 else 0,
         a[5] if len(a) > 5 else "group",
         int(a[6]) if len(a) > 6 else 0,
         int(a[7]) if len(a) > 7 else 0,
         a[8] if len(a) > 8 and a[8] != "none" else None,
         a[9] if len(a) > 9 else "synthetic")

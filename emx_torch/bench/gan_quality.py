"""GAN infilling quality anchor (port of emx/bench/gan_quality.py).

Trains the infilling GAN (the G+D step, adaptive scheduling, collapse
rollback) on 1/coverage partial scans of synthetic micrographs and
scores the masked-region PSNR on a held-out set against the classical
interpolation ladder (emx_torch.analysis.inpaint): the infilling
counterpart of the denoiser's classical-filter anchor (reference
gan-infilling-100.py:1025-1036,1635-1642).

The nets are emx's `scale`d widths in bfloat16 with float32 parameters.
A run resumes from its latest checkpoint (out_dir/ckpt), or starts from
`init_from`, a gan_state.npz of emx's or the port's (the nets and the
EMAs; the step from its meta; the optimizers fresh). With `steps` at or
below the start step nothing trains and the state is only scored: the
eval-only path that scores a committed state. Each segment of 5000 steps
refreshes out_dir/gan_state.npz in emx's keys.

Port additions to emx's API: `corpus_size` (emx's 1024 images),
`log_every` (emx's 100) and `device` (the card unless the caller asks
for the CPU).

Usage: python -m emx_torch.bench.gan_quality <out_dir> [steps] [batch]
           [size] [scale] [mse_weight] [init_from|none] [coverage]
Writes <out_dir>/quality.json and metrics.jsonl; prints the summary as
one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from emx_torch.analysis.inpaint import compare_infills, masked_psnr
from emx_torch.data import DeviceDataset, PipelineConfig
from emx_torch.data.degrade import (apply_partial_scan, fixed_scan_mask,
                                    infilling_example, norm_neg1to1)
from emx_torch.data.pipeline import synthetic_micrographs
from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                    MultiscaleDiscriminator)
from emx_torch.serve.artifact import load_gan_state, save_gan_state
from emx_torch.train import Checkpointer
from emx_torch.train.gan import GANConfig, GANTrainer
from emx_torch.utils.device import resolve_device
from emx_torch.utils.image import sanitize

SEGMENT = 5000
VAL_SEED, VAL_SIZE = 999, 32


def net_config(scale: float) -> InfillingConfig:
    """emx.bench.gan_quality's nets: the reference widths at `scale`,
    group norm, bfloat16 compute."""
    return dataclasses.replace(InfillingConfig().scaled(scale),
                               norm="group", dtype=torch.bfloat16)


def val_scans(size: int, coverage: int, device: torch.device):
    """The held-out set: synthetic_micrographs(32, size, seed=999) in
    [-1, 1] and its partial scans under the fixed mask. Returns
    (masked, clean, mask)."""
    mask = fixed_scan_mask((size, size), 1 / coverage, device=device)
    clean = torch.from_numpy(synthetic_micrographs(
        VAL_SIZE, size, seed=VAL_SEED)).to(device)
    clean = norm_neg1to1(sanitize(clean, 0.0))
    return apply_partial_scan(clean, mask), clean, mask


def score(gen: torch.nn.Module, masked: torch.Tensor, clean: torch.Tensor,
          mask: torch.Tensor) -> dict:
    """compare_infills with the generator as `nn` (scanned pixels copied
    through) and the identity row, in [-1, 1] (max_val 2)."""
    def nn_fn(x):
        with torch.no_grad():
            return torch.where(mask, x, gen(x, train=False))

    results = compare_infills(masked, clean, mask, nn_fn=nn_fn, max_val=2.0)
    identity = float(torch.mean(masked_psnr(masked, clean, mask, 2.0)))
    return {"all": results, "identity": identity}


def main(out_dir: str, steps: int = 20000, batch: int = 8, size: int = 256,
         scale: float = 0.5, mse_weight: float = 10.0,
         init_from: str | None = None, coverage: int = 64,
         corpus_size: int = 1024, log_every: int = 100,
         device: str | torch.device = "cuda") -> dict:
    """`coverage`: 1/coverage of the pixels are scanned: 64 is the
    reference gan-infilling contract (gan-infilling-100.py:1173-1175),
    100 the partial-STEM one (stem_infilling-100.py:1326-1328)."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    net_cfg = net_config(scale)
    cfg = GANConfig(
        gen_lr=2e-4, disc_lr=2e-4, log_every=log_every,
        trainee_switch_skip_n=2, max_num_since_change=32,
        ckpt_every_steps=1000, model_dir=out_dir, seed=0,
        mse_weight=mse_weight)
    mask = fixed_scan_mask((size, size), 1 / coverage)
    trainer = GANTrainer(InfillingGenerator(net_cfg, device=device),
                         MultiscaleDiscriminator(net_cfg, device=device),
                         cfg, example_fn=infilling_example(mask))
    train_imgs = synthetic_micrographs(corpus_size, size, seed=0)
    pipe = DeviceDataset(train_imgs, PipelineConfig(batch_size=batch,
                                                    crop_size=size),
                         device=device)
    state = trainer.init()
    ckpt = Checkpointer(os.path.join(out_dir, "ckpt"))
    if ckpt.latest_step() is not None:
        state, pipe_state = ckpt.restore(state)
        if pipe_state:
            pipe.load_state_dict(pipe_state)
    elif init_from:
        # Warm start from a committed state: nets and the scheduler's EMAs,
        # fresh optimizer moments (as emx's init_from).
        meta = load_gan_state(init_from, state)
        state.step = int(meta.get("step", 0))

    def save_resume(state):
        save_gan_state(os.path.join(out_dir, "gan_state.npz"), state,
                       meta={"step": int(state.step), "scale": scale,
                             "size": size, "mse_weight": mse_weight,
                             "coverage": coverage})

    start = int(state.step)
    t0 = time.perf_counter()
    while state.step < steps:
        state = trainer.fit(state, pipe,
                            num_steps=min(steps, state.step + SEGMENT),
                            checkpointer=ckpt)
        save_resume(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = max(time.perf_counter() - t0, 1e-9)
    ckpt.save(int(state.step), state, pipe.state_dict())
    save_resume(state)

    scored = score(state.gen, *val_scans(size, coverage, device))
    results, identity = scored["all"], scored["identity"]
    best = max(((k, v["psnr_masked"]) for k, v in results.items()
                if k != "nn"), key=lambda kv: kv[1])
    summary = {
        "metric": "gan_infilling_quality",
        "steps": int(state.step), "batch": batch, "size": size,
        "scale": scale, "coverage": f"1/{coverage}",
        "mse_weight": mse_weight,
        "train_step_per_s": round((int(state.step) - start) / train_s, 3),
        "nn_psnr_masked": round(results["nn"]["psnr_masked"], 3),
        "best_classical": [best[0], round(best[1], 3)],
        "identity_psnr_masked": round(identity, 3),
        "all": {k: round(v["psnr_masked"], 3) for k, v in results.items()},
        # Unrounded, for comparisons finer than the record's 3 decimals.
        "all_exact": {k: v["psnr_masked"] for k, v in results.items()},
        "identity_exact": identity,
    }
    with open(os.path.join(out_dir, "quality.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    a = [x for x in sys.argv[1:] if not x.startswith("--")]
    dev = next((x.split("=", 1)[1] for x in sys.argv[1:]
                if x.startswith("--device=")), "cuda")
    main(a[0] if a else "runs/gan_quality",
         int(a[1]) if len(a) > 1 else 20000,
         int(a[2]) if len(a) > 2 else 8,
         int(a[3]) if len(a) > 3 else 256,
         float(a[4]) if len(a) > 4 else 0.5,
         float(a[5]) if len(a) > 5 else 10.0,
         a[6] if len(a) > 6 and a[6] != "none" else None,
         int(a[7]) if len(a) > 7 else 64, device=dev)

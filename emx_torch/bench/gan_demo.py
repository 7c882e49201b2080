"""GAN training-dynamics demonstration (port of emx/bench/gan_demo.py).

Runs the real G+D step at half the reference widths and records
metrics JSONL showing:
  * band oscillation: the trainee flipping on the window-averaged
    D(fake) (reference gan-infilling-100.py:1903-1940);
  * one collapse -> rollback round trip through the real Checkpointer:
    at the midpoint the discriminator is zeroed (a simulated mode
    collapse: D outputs exactly 0.5, the reference's signature
    :1827-1831) and fit must detect it and restore the last checkpoint;
  * the forced trainee switch after max_num_since_change one-sided
    windows (:1922-1925), in a last segment of 150 steps with the
    generator's learning rate at 0 and the bands raised, so that every
    window decides for the generator.

A checkpoint must exist before the collapse: checkpoints come every 100
steps, so `steps` of 200 or more. Port addition to emx's API: `device`
(the card unless the caller asks for the CPU). The CPU tests shrink
SIZE, BATCH and NET.

Usage: python -m emx_torch.bench.gan_demo [out_dir] [steps]
Writes <out_dir>/metrics.jsonl and prints a JSON summary line.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from emx_torch.data import DeviceDataset, PipelineConfig
from emx_torch.data.degrade import fixed_scan_mask, infilling_example
from emx_torch.data.pipeline import synthetic_micrographs
from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                    MultiscaleDiscriminator)
from emx_torch.train import Checkpointer, set_learning_rate
from emx_torch.train.gan import GANConfig, GANTrainer
from emx_torch.utils.device import resolve_device
from emx_torch.utils.metrics import read_jsonl

SIZE, BATCH = 256, 8
# Half the reference generator and discriminator.
NET = InfillingConfig(
    gen_features=(16, 32, 32, 16), nin_down=(64, 128, 384),
    nin_up=(128, 64, 32), num_global_blocks=4, num_local_blocks=2,
    disc_features=(16, 32, 64, 128), norm="group")
STARVE_STEPS = 150


def main(out_dir: str = "runs/gan_demo", steps: int = 1200,
         device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    size, batch = SIZE, BATCH
    os.makedirs(out_dir, exist_ok=True)
    cfg = GANConfig(
        gen_lr=2e-4, disc_lr=2e-4, log_every=1,
        trainee_switch_skip_n=2, max_num_since_change=8,
        ckpt_every_steps=100, model_dir=out_dir, collapse_eps=1e-6)
    mask = fixed_scan_mask((size, size), coverage=1 / 64)
    trainer = GANTrainer(InfillingGenerator(NET, device=device),
                         MultiscaleDiscriminator(NET, device=device), cfg,
                         example_fn=infilling_example(mask))
    data = synthetic_micrographs(64, size, seed=3)
    pipe = DeviceDataset(data, PipelineConfig(batch_size=batch,
                                              crop_size=size),
                         device=device)
    state = trainer.init()
    ckpt = Checkpointer(os.path.join(out_dir, "ckpt"))

    state = trainer.fit(state, pipe, num_steps=steps // 2, checkpointer=ckpt)

    # Simulated mode collapse: zero the discriminator, so that D(x) is
    # exactly 0.5 on real and fake.
    with torch.no_grad():
        for p in state.disc.parameters():
            p.zero_()
    state = trainer.fit(state, pipe, num_steps=steps, checkpointer=ckpt)

    # Starvation: freeze the generator and raise the bands, so that every
    # window's D(fake) sits below switch_low; the forced switch must fire.
    set_learning_rate(state.gen_opt, 0.0)
    trainer.cfg.switch_low = 0.85
    trainer.cfg.switch_high = 0.95
    state = trainer.fit(state, pipe, num_steps=steps + STARVE_STEPS,
                        checkpointer=ckpt)
    ckpt.close()
    trainer.logger.close()

    recs = read_jsonl(os.path.join(out_dir, "metrics.jsonl"))
    trainees = [r.get("train_gen") for r in recs if "train_gen" in r]
    summary = {
        "metric": "gan_demo",
        "steps": int(state.step),
        "trainee_switches": sum(1 for a, b in zip(trainees, trainees[1:])
                                if a != b),
        "both_trained": len(set(trainees)) == 2,
        "forced_switches": max((r.get("forced_switches", 0) for r in recs),
                               default=0),
        "rollbacks": max((r.get("rollback", 0) for r in recs), default=0),
        "final_d_fake": next((r["d_fake"] for r in reversed(recs)
                              if "d_fake" in r), None),
        "final_mse": next((r["mse"] for r in reversed(recs)
                           if "mse" in r), None),
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    args = [x for x in sys.argv[1:] if not x.startswith("--")]
    dev = next((x.split("=", 1)[1] for x in sys.argv[1:]
                if x.startswith("--device=")), "cuda")
    main(args[0] if args else "runs/gan_demo",
         int(args[1]) if len(args) > 1 else 1200, device=dev)

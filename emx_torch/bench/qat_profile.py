"""Where the time of one tail-distillation step goes, on the card.

    python -m emx_torch.bench.qat_profile [--bundle PATH] [--steps 5]

The flagship's recipe (qat_finetune.head_distill: scope decoder2, mode
mxu, batch 16 at 512x512, lr 5e-5) on the bundle's float parameters,
with a corpus of 32 synthetic micrographs (the corpus only feeds the
batch gather). Three programs are profiled, each after warm-up calls:
the whole step (batch synthesis on K2, the int8 capture forward, the
fake-quant tail forward and backward, Adam), the capture forward alone,
and the tail forward and backward alone on fixed inputs. For each: the
host-clock ms per call (ending in a synchronize), the device's busy ms
and idle share, the kernels per call and the kernels that take the most
device time; for the step also K2's device ms and the peak memory.
Prints one JSON line per program. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import json

import torch

from emx_torch.bench.forward_profile import profile_forward
from emx_torch.bench.ladders import val_ladder
from emx_torch.bench.qat_finetune import (STEP_SEED, TailDistiller,
                                          training_corpus)
from emx_torch.bench.quant_check import deployment_model
from emx_torch.serve.quantize import calibrate
from emx_torch.train.losses import huberised_mse
from emx_torch.utils.device import card_name_and_power
from emx_torch.utils.rng import fold_in


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bundle", default="docs/runs/flagship/artifact_int8.npz")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("qat_profile measures the card: no CUDA device")
    device = torch.device("cuda", 0)
    card = card_name_and_power()
    cfg, flat, model = deployment_model(args.bundle, device)
    noisy, _ = val_ladder(device)
    amax, order = calibrate(model, [noisy[:8]], return_order=True)
    d = TailDistiller(cfg, flat, model, amax, order, "decoder2", "mxu",
                      training_corpus("synthetic", 32, 512, device),
                      args.batch, 5e-5)
    seeds = (fold_in(STEP_SEED, i) for i in itertools.count())
    torch.cuda.reset_peak_memory_stats(device)
    step = profile_forward(lambda _: d.step(next(seeds)), None,
                           n=args.steps, match="degrade_")
    step["k2_ms"] = step.pop("matched_ms")
    step["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    cat = d.inputs(d.capture_fn(d.lq0)[1], d.lq0)
    tgt = d.lq0

    def tail_fwd_bwd(_):
        loss = huberised_mse(d.fq_tail(d.tail, cat).float(), tgt)
        d.tail.zero_grad(set_to_none=True)
        loss.backward()

    parts = {"step": step,
             "capture_forward": profile_forward(d.capture_fn, d.lq0,
                                                n=args.steps),
             "tail_forward_backward": profile_forward(tail_fwd_bwd, None,
                                                      n=args.steps)}
    for name, res in parts.items():
        print(json.dumps({"program": name, "scope": "decoder2",
                          "batch": args.batch, "card": card, **res}),
              flush=True)


if __name__ == "__main__":
    main()

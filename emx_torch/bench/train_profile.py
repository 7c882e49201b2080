"""Where the time of one train step goes, on the card.

    python -m emx_torch.bench.train_profile [--batch 16] [--steps 5] [--mesh]

The flagship's training config at full width (BatchNorm, bf16, s2d 4,
folded head 128; batch 16 at 512x512, nesterov 1e-3), with the middle
blocks rematerialised and without: the host-clock ms per step (steps
run back to back, one synchronize at the end), the device's busy ms and
idle share, the kernels launched per step, K2's device ms per step, the
peak memory, and the kernels that take the most device time. Prints one
JSON line per configuration. Weights are initialised from a seed and
the corpus is made with numpy. Needs a CUDA card.

`--mesh` profiles the rematerialised step without a mesh and under the
one-rank data-parallel mesh of an NCCL group on a free local port
(emx_torch.parallel), in the order plain, mesh, mesh, plain, and adds
the host's ms per step outside the profiler (CUDA-synchronised, steps
back to back) to each line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from emx_torch.bench.forward_profile import profile_forward
from emx_torch.data import (DeviceDataset, PipelineConfig, denoiser_example,
                            synthetic_micrographs)
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.train import TrainConfig, Trainer
from emx_torch.utils.device import card_name_and_power

# The flagship's training config (docs/runs/quality_r5/quality.json) at
# full width: widths 64/128/256/728/728, 11 middle blocks, ASPP 728 -> 256.
FLAGSHIP_TRAIN = DenoiserConfig(norm="batch", dtype=torch.bfloat16,
                                space_to_depth=4, folded_head=128,
                                remat_middle=True)


def profile_train(config: DenoiserConfig, batch: int, steps: int,
                  device: torch.device, mesh=None) -> dict:
    model = Denoiser(config, device=device)
    trainer = Trainer(model, TrainConfig(learning_rate=1e-3, log_every=0),
                      mesh=mesh, example_fn=denoiser_example)
    state = trainer.init()
    data = iter(DeviceDataset(
        synthetic_micrographs(2 * batch, 512),
        PipelineConfig(batch_size=batch, crop_size=512), device=device))
    torch.cuda.reset_peak_memory_stats(device)
    res = profile_forward(lambda _: trainer.step_fn(state, next(data)),
                          None, n=steps, match="degrade_")
    res["k2_ms"] = res.pop("matched_ms")
    res["kernels_per_step"] = res.pop("kernels_per_forward")
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.step_fn(state, next(data))
    torch.cuda.synchronize(device)
    res["host_ms_unprofiled"] = 1e3 * (time.perf_counter() - t0) / steps
    return {**res,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--mesh", action="store_true",
                    help="plain against the one-rank NCCL mesh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("train_profile measures the card: no CUDA device")
    device = torch.device("cuda", 0)
    card = card_name_and_power()
    if args.mesh:
        profile_mesh(args.batch, args.steps, device, card)
        return
    for remat in (True, False):
        cfg = dataclasses.replace(FLAGSHIP_TRAIN, remat_middle=remat)
        res = profile_train(cfg, args.batch, args.steps, device)
        print(json.dumps({"config": "flagship_train", "remat_middle": remat,
                          "batch": args.batch, "card": card, **res}),
              flush=True)


def profile_mesh(batch: int, steps: int, device: torch.device,
                 card: str) -> None:
    import socket

    import torch.distributed as dist

    from emx_torch.parallel import make_mesh_for_batch
    from emx_torch.parallel.distributed import initialize

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh_for_batch(batch, device=device)
        for meshed in (False, True, True, False):
            res = profile_train(FLAGSHIP_TRAIN, batch, steps, device,
                                mesh if meshed else None)
            print(json.dumps({"config": "flagship_train", "mesh": meshed,
                              "batch": batch, "card": card, **res}),
                  flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

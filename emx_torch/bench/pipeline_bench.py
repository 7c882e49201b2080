"""Input-pipeline throughput (port of emx/bench/pipeline_bench.py): the
host loader (the port's TIFF reader + crop, and packed .npy stacks) and
the degrade of training examples on the card (K2 with its D4 and
target), in images per second.

    python -m emx_torch.bench.pipeline_bench [n_files] [crop]

Prints one JSON line with the card's name and power limit. Files are
written to a temporary directory from a seeded numpy generator. Needs a
CUDA card for the degrade rate unless `device="cpu"` is passed.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from emx_torch.utils.device import card_name_and_power, resolve_device


def loader_rate(pipe, n_batches: int = 20) -> float:
    """img/s of `pipe`'s iterator after one warm-up batch: the median of
    three windows of `n_batches` (a shared host's neighbours can halve
    one window)."""
    it = iter(pipe)
    next(it)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_batches):
            b = next(it)
        rates.append(len(b) * n_batches / (time.perf_counter() - t0))
    return sorted(rates)[1]


def degrade_rate(device: torch.device, batch: int = 32, crop: int = 512,
                 launches: int = 10) -> float:
    """img/s of denoiser_example (its draws, D4, K2 and target) on a
    (batch, crop, crop) batch already on the device."""
    from emx_torch.data.degrade import denoiser_example

    x = torch.from_numpy(np.random.default_rng(0).random(
        (batch, crop, crop), np.float32)).to(device)
    acc = denoiser_example(0, x)[0].sum()
    float(acc)
    t0 = time.perf_counter()
    for i in range(launches):
        lq, tgt = denoiser_example(i + 1, x)
        acc = acc + lq.sum() + tgt.sum()
    float(acc)
    return batch * launches / (time.perf_counter() - t0)


def measure(n_files: int = 256, crop: int = 512,
            device: str | torch.device = "cuda") -> dict:
    from emx_torch.data.harvest import quantize_pack
    from emx_torch.data.pipeline import DataPipeline, PipelineConfig
    from emx_torch.io.tiff import write_tiff

    device = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="emx_torch_pipe_bench_")
    try:
        rng = np.random.default_rng(0)
        paths = []
        for i in range(n_files):
            p = os.path.join(tmp, f"{i}.tif")
            write_tiff(p, rng.random((crop, crop), np.float32))
            paths.append(p)
        out = {"metric": "input_pipeline", "crop": crop}
        out["host_loader_tiff_img_per_s"] = loader_rate(DataPipeline(
            paths, PipelineConfig(batch_size=32, crop_size=crop,
                                  num_workers=8, prefetch=8)))
        base = rng.random((n_files, crop, crop)).astype(np.float32)
        for key, dtype in (("host_loader_img_per_s", np.float32),
                           ("host_loader_u16_img_per_s", np.uint16),
                           ("host_loader_u8_img_per_s", np.uint8),
                           ("host_loader_f16_img_per_s", np.float16)):
            packed = os.path.join(tmp, f"packed_{np.dtype(dtype).name}.npy")
            np.save(packed, quantize_pack(base, dtype))
            out[key] = loader_rate(DataPipeline(
                np.load(packed, mmap_mode="r"),
                PipelineConfig(batch_size=32, crop_size=crop)))
        out["device_degrade_img_per_s"] = degrade_rate(device, 32, crop)
        out["device"] = (card_name_and_power() if device.type == "cuda"
                         else "cpu")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(n_files: int = 256, crop: int = 512) -> None:
    print(json.dumps(measure(n_files, crop)))


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])

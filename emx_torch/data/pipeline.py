"""Device-resident training data (port of part of emx/data/pipeline.py).

  * `PipelineConfig`, as emx's;
  * `DeviceDataset`: the whole corpus lives on the device and batches are
    gathered there; the epoch order is a permutation from a generator
    seeded by (seed, epoch), and the (epoch, index) cursor is saved and
    restored with `state_dict` / `load_state_dict`, so a resumed run sees
    the batches an uninterrupted one sees;
  * `synthetic_micrographs`, a verbatim copy (numpy only, bit-identical).

`DataPipeline` (TIFF files through a thread pool) and the ctf, grain,
filament, porous and mixed corpora are not ported yet (ROADMAP.md
Queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from emx_torch.utils.config import Config, config_field
from emx_torch.utils.device import resolve_device
from emx_torch.utils.rng import fold_in


@dataclasses.dataclass
class PipelineConfig(Config):
    batch_size: int = config_field(8, "global batch size")
    crop_size: int = config_field(512, "training crop sidelength")
    seed: int = config_field(0, "pipeline RNG seed")
    num_workers: int = config_field(4, "file-read threads")
    prefetch: int = config_field(4, "prefetched batches")
    drop_remainder: bool = config_field(True, "drop last partial batch")


class DeviceDataset:
    """Iterates (B, crop, crop) float32 batches of a corpus held on
    `device` (CUDA unless the caller asks for the CPU). An integer corpus
    is uploaded as it is and cast on the device.

    Unlike emx's, it raises when batch_size exceeds the corpus, where
    emx's iterator would loop over empty epochs for ever."""

    def __init__(self, data: np.ndarray, config: PipelineConfig,
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        self._n = data.shape[0]
        if config.crop_size != data.shape[-1]:
            raise ValueError("DeviceDataset serves full images; pre-crop "
                             "to crop_size")
        if not 0 < config.batch_size <= self._n:
            raise ValueError(f"batch_size {config.batch_size} does not fit "
                             f"a corpus of {self._n} images")
        self.data = torch.as_tensor(data).to(self.device).float()
        self.epoch = 0
        self.index = 0

    def state_dict(self) -> dict[str, int]:
        return {"epoch": self.epoch, "index": self.index}

    def load_state_dict(self, state: dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.index = int(state["index"])

    def __iter__(self):
        b = self.cfg.batch_size
        while True:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(fold_in(self.cfg.seed, self.epoch))
            perm = torch.randperm(self._n, generator=gen, device=self.device)
            while self.index + b <= self._n:
                idx = perm[self.index:self.index + b]
                # Advance the cursor BEFORE yielding so state_dict() taken
                # between batches resumes at the right position.
                self.index += b
                yield self.data.index_select(0, idx)
            self.epoch += 1
            self.index = 0


def synthetic_micrographs(n: int, size: int = 512, seed: int = 0) -> np.ndarray:
    """Structured synthetic micrographs (Gaussian blobs + lattice fringes +
    smooth background) for tests and benchmarks — stands in for the
    harvested corpus, which cannot ship."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        img = 0.3 + 0.2 * np.sin(2 * np.pi * (rng.uniform(1, 4) * xx + rng.uniform(0, 1)))
        for _ in range(6):  # particles
            cy, cx = rng.uniform(0.1, 0.9, 2)
            s = rng.uniform(0.02, 0.12)
            a = rng.uniform(0.2, 0.6)
            img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
        f = rng.uniform(20, 60)
        ang = rng.uniform(0, np.pi)
        img = img + 0.08 * np.sin(2 * np.pi * f * (np.cos(ang) * xx + np.sin(ang) * yy))
        lo, hi = img.min(), img.max()
        out[i] = (img - lo) / (hi - lo)
    return out

"""Overlapped-tile inference on large micrographs (port of
emx/serve/tiling.py).

Windows of `tile` pixels with `overlap` pixels of overlap cover the
image, the last one clamped flush to the edge. They run through the
model in batches of `batch` windows, and overlapping outputs are
averaged on the device. Images smaller than a tile are grown by
repeated reflection first and cropped back after. `TiledApplier` binds
a model to these settings, with whole-image preprocessing.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emx_torch.utils.image import sanitize, scale0to1


def _origins(extent: int, tile: int, stride: int) -> np.ndarray:
    """Window origins covering [0, extent), the last clamped to the edge."""
    if extent <= tile:
        return np.asarray([0])
    xs = list(range(0, extent - tile + 1, stride))
    if xs[-1] != extent - tile:
        xs.append(extent - tile)
    return np.asarray(xs)


def _tiled_apply(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                 img: torch.Tensor, tile: int, overlap: int,
                 batch: int) -> torch.Tensor:
    h, w = img.shape
    stride = tile - overlap
    coords = [(int(y), int(x)) for y in _origins(h, tile, stride)
              for x in _origins(w, tile, stride)]
    canvas = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    counts = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for i in range(0, len(coords), batch):
        group = coords[i:i + batch]
        crops = torch.stack([img[y:y + tile, x:x + tile] for y, x in group])
        out = apply_fn(crops).float()
        for (y, x), o in zip(group, out):
            canvas[y:y + tile, x:x + tile] += o
            counts[y:y + tile, x:x + tile] += 1.0
    return canvas / torch.clamp(counts, min=1.0)


def tiled_apply(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                img: torch.Tensor, tile: int = 512, overlap: int = 80,
                batch: int = 4) -> torch.Tensor:
    """Apply `apply_fn((B, tile, tile)) -> (B, tile, tile)` over a 2D
    image of any size with overlap averaging; float32 out, on the
    image's device."""
    img = img.float()
    h, w = img.shape
    if h >= tile and w >= tile:
        return _tiled_apply(apply_fn, img, tile, overlap, batch)
    # Reflect padding grows an axis by at most its size - 1 per step.
    padded = img[None, None]
    while padded.shape[-2] < tile or padded.shape[-1] < tile:
        ph = min(max(0, tile - padded.shape[-2]), padded.shape[-2] - 1)
        pw = min(max(0, tile - padded.shape[-1]), padded.shape[-1] - 1)
        if ph == 0 and pw == 0:
            # A 1-pixel extent cannot be reflected: repeat the edge.
            padded = F.pad(padded, (0, max(0, tile - padded.shape[-1]),
                                    0, max(0, tile - padded.shape[-2])),
                           mode="replicate")
            break
        padded = F.pad(padded, (0, pw, 0, ph), mode="reflect")
    out = _tiled_apply(apply_fn, padded[0, 0], tile, overlap, batch)
    return out[:h, :w]


class TiledApplier:
    """A model bound to tiling settings (the `Denoiser` class shape of the
    reference, machine_learning/denoiser.py:584-682). Images go to the
    device of the model's parameters."""

    def __init__(self, model: nn.Module, tile: int = 512, overlap: int = 80,
                 batch: int = 4, preprocess: bool = True):
        self.model = model
        self.tile, self.overlap, self.batch = tile, overlap, batch
        self.preprocess = preprocess
        self.device = next(model.parameters()).device

    def _apply_fn(self, crops: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(crops)

    def _pre(self, img: torch.Tensor) -> torch.Tensor:
        """Whole-image sanitize + rescale to [0, 1] (reference
        Denoiser.preprocess:632-642, once per image)."""
        return scale0to1(sanitize(img))

    def _input(self, img, preprocess: bool | None) -> torch.Tensor:
        img = torch.as_tensor(img, dtype=torch.float32).to(self.device)
        if self.preprocess if preprocess is None else preprocess:
            img = self._pre(img)
        return img

    def apply_crop(self, crop, preprocess: bool | None = None
                   ) -> torch.Tensor:
        """One window through the model (reference denoise_crop:645-651)."""
        return self._apply_fn(self._input(crop, preprocess)[None])[0]

    def __call__(self, img, preprocess: bool | None = None) -> torch.Tensor:
        return tiled_apply(self._apply_fn, self._input(img, preprocess),
                           self.tile, self.overlap, self.batch)

"""Cropping / resizing / tiling primitives (port of emx/data/crops.py),
on tensors of any device.

Rebuilds the reference's harvest geometry: crop-to-square + box resize to
2048 (DM3stoTIFs-batch/img_params.m:26-31), non-overlapping 512 tiling
(machine_learning/crop_arm_scans.py:1-62), and random training crops.

`box_resize` at an integer ratio is a mean over f x f blocks, summed in
the order XLA's CPU code sums emx's reshape-mean and scaled by the
float32 reciprocal of f*f, as XLA does, so the two agree on the CPU bit
for bit (f = 2 to 8 checked). At another ratio it is
`F.interpolate(mode="bilinear", align_corners=False, antialias=s > size)`,
emx's `jax.image.resize(..., "linear", antialias=s > size)`, within
1e-5 (different summation orders); no matrix product is involved, so
TF32 does not enter on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def center_square_crop(img: torch.Tensor) -> torch.Tensor:
    """Crop the larger dimension so the image is square (top-left anchored,
    as the reference's imcrop([1 1 s-1 s-1]) is)."""
    s = min(img.shape[-2], img.shape[-1])
    return img[..., :s, :s]


def box_resize(img: torch.Tensor, size: int) -> torch.Tensor:
    """Resize a square image (..., s, s) to (size, size) with area-average
    (box) semantics: an exact block mean when the ratio is an integer,
    otherwise an antialiased linear resize."""
    s = img.shape[-1]
    if s == size:
        return img
    if s > size and s % size == 0:
        f = s // size
        blocks = img.reshape(*img.shape[:-2], size, f, size, f)
        if f == 2:  # XLA's CPU order here: the two row sums, then theirs
            acc = ((blocks[..., 0, :, 0] + blocks[..., 0, :, 1])
                   + (blocks[..., 1, :, 0] + blocks[..., 1, :, 1]))
        else:       # and above: one running sum, row offset outer
            acc = blocks[..., 0, :, 0]
            for i in range(f):
                for j in range(f):
                    if i or j:
                        acc = acc + blocks[..., i, :, j]
        # XLA turns emx's division by f*f into a product with its
        # float32 reciprocal; so does this.
        return acc * (1.0 / (f * f))
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, s, s)
    out = F.interpolate(x, size=(size, size), mode="bilinear",
                        align_corners=False, antialias=s > size)
    return out.reshape(*lead, size, size)


def harvest_preprocess(img: torch.Tensor, size: int = 2048) -> torch.Tensor:
    """Square-crop + box-resize in float32: the canonical reaper transform
    (img_params.m:26-31) producing census-ready images."""
    return box_resize(center_square_crop(img.float()), size)


def tile_grid(img: torch.Tensor, tile: int = 512) -> torch.Tensor:
    """Non-overlapping tiles: (..., ny*nx, tile, tile). Trailing remainder
    pixels are dropped (crop_arm_scans.py tiling semantics)."""
    h, w = img.shape[-2], img.shape[-1]
    ny, nx = h // tile, w // tile
    img = img[..., : ny * tile, : nx * tile]
    t = img.reshape(*img.shape[:-2], ny, tile, nx, tile)
    t = t.movedim(-2, -3)
    return t.reshape(*img.shape[:-2], ny * nx, tile, tile)


def untile_grid(tiles: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    tile = tiles.shape[-1]
    t = tiles.reshape(*tiles.shape[:-3], ny, nx, tile, tile)
    t = t.movedim(-2, -3)
    return t.reshape(*tiles.shape[:-3], ny * tile, nx * tile)


def random_crop(generator: torch.Generator, img: torch.Tensor,
                size: int) -> torch.Tensor:
    """Random square crop, offsets drawn from `generator` (a CPU
    generator: the offsets are host integers that slice the image)."""
    h, w = img.shape[-2], img.shape[-1]
    y = int(torch.randint(0, h - size + 1, (), generator=generator))
    x = int(torch.randint(0, w - size + 1, (), generator=generator))
    return img[..., y:y + size, x:x + size]

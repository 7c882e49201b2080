"""Image utilities (port of emx/utils/image.py)."""

from __future__ import annotations

import torch


def scale0to1(img: torch.Tensor, dim=None) -> torch.Tensor:
    """Rescale to [0, 1]; constant images map to 0.5. Pass dim=(-2, -1)
    to normalise each image of a batch on its own."""
    if dim is None:
        lo, hi = img.min(), img.max()
    else:
        lo = torch.amin(img, dim=dim, keepdim=True)
        hi = torch.amax(img, dim=dim, keepdim=True)
    span = hi - lo
    safe = torch.where(span > 0, span, torch.ones_like(span))
    out = (img - lo) / safe
    return torch.where(span > 0, out, torch.full_like(img, 0.5))


def psnr(pred: torch.Tensor, truth: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - truth) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def sanitize(img: torch.Tensor, fill: float = 0.5) -> torch.Tensor:
    """Replace NaN/Inf with `fill`."""
    return torch.where(torch.isfinite(img), img, torch.full_like(img, fill))

"""Image utilities (port of emx/utils/image.py)."""

from __future__ import annotations

import functools

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


# D4 transform `choice` as (transpose, flip rows, flip columns), applied in
# that order; the rows follow emx's branch order: identity, rot90 x1, x2,
# x3, flip(0), flip(1), flip(rot90, 0), flip(rot90, 1).
_D4 = ((0, 0, 0), (1, 1, 0), (0, 1, 1), (1, 0, 1),
       (0, 1, 0), (0, 0, 1), (1, 0, 0), (1, 1, 1))


@functools.cache
def _d4_table(device: torch.device) -> torch.Tensor:
    return torch.tensor(_D4, dtype=torch.bool, device=device)


def flip_rotate(imgs: torch.Tensor, choices: torch.Tensor) -> torch.Tensor:
    """Apply to each square image of a (B, H, H) batch the D4 transform
    `choices[b]` in [0, 8), as emx's flip_rotate does to one image.
    No host synchronisation, and no copy from the host after the first
    call on a device (a CUDA graph can capture it): every image goes
    through three selects."""
    if imgs.dim() != 3 or imgs.shape[-1] != imgs.shape[-2]:
        raise ValueError(f"flip_rotate takes (B, H, H), got {tuple(imgs.shape)}")
    table = _d4_table(imgs.device)
    flags = table[choices.to(imgs.device).long()][:, :, None, None]
    out = torch.where(flags[:, 0], imgs.transpose(-1, -2), imgs)
    out = torch.where(flags[:, 1], out.flip(-2), out)
    # where() may lay its output out like the transposed view.
    return torch.where(flags[:, 2], out.flip(-1), out).contiguous()

"""Classical partial-scan infilling baselines and masked-region scoring
(port of emx/analysis/inpaint.py): interpolate the unscanned pixels
classically, then score the masked region only.

  * `normconv_fill`  Gaussian normalized convolution (Knutsson-Westin):
    conv(mask * img) / conv(mask).
  * `nearest_fill`   iterative 3x3 dilation fill.
  * `harmonic_fill`  Jacobi relaxation of the Laplace equation on the
    unknown region with the known pixels clamped (torch.roll wraps, as
    jnp.roll does).

Every fill takes a batch (..., H, W) and a (H, W) mask on the batch's
device, and runs the whole batch at once (emx vmaps over images). The
separable convolutions are zero-padded cross-correlations computed as
sums of shifted copies: exact float32 on every device, where a cuDNN
convolution may take TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gauss_kernel(sigma: float, radius: int,
                  device: torch.device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _sep_conv2(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 2-D cross-correlation of the last two dims with SAME zero
    padding (emx's _sep_conv2)."""
    pad = (k.shape[0] - 1) // 2
    h, w = img.shape[-2:]
    p = F.pad(img, (0, 0, pad, pad))
    out = sum(k[i] * p[..., i:i + h, :] for i in range(k.shape[0]))
    p = F.pad(out, (pad, pad))
    return sum(k[i] * p[..., i:i + w] for i in range(k.shape[0]))


def normconv_fill(img: torch.Tensor, mask: torch.Tensor,
                  sigma: float = 4.0) -> torch.Tensor:
    """Gaussian normalized-convolution interpolation of unscanned pixels;
    the values of `img` outside `mask` are ignored."""
    m = mask.to(torch.float32)
    radius = max(3, int(3 * sigma))
    k = _gauss_kernel(sigma, radius, img.device)
    num = _sep_conv2(img * m, k)
    den = _sep_conv2(m.expand_as(img), k)
    filled = num / torch.clamp(den, min=1e-12)
    return torch.where(mask, img, filled)


def nearest_fill(img: torch.Tensor, mask: torch.Tensor,
                 iters: int = 32) -> torch.Tensor:
    """Iterative 3x3 dilation fill: each unknown pixel takes the mean of
    already-known neighbours, repeated until the mask floods the image."""
    k = torch.ones(3, dtype=torch.float32, device=img.device)
    m = mask.to(torch.float32).expand_as(img)
    val = img * m
    for _ in range(iters):
        num = _sep_conv2(val * m, k)
        den = _sep_conv2(m, k)
        new = num / torch.clamp(den, min=1e-12)
        val = torch.where(m > 0, val, new)
        m = torch.maximum(m, (den > 0).to(torch.float32))
    return torch.where(mask, img, val)


def harmonic_fill(img: torch.Tensor, mask: torch.Tensor,
                  iters: int = 400) -> torch.Tensor:
    """Laplace-equation (harmonic) inpainting by Jacobi relaxation with the
    known pixels clamped, from the normalized-convolution fill."""
    u = normconv_fill(img, mask, sigma=4.0)
    for _ in range(iters):
        avg = 0.25 * (torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
                      + torch.roll(u, 1, -1) + torch.roll(u, -1, -1))
        u = torch.where(mask, u, avg)
    return u


def masked_psnr(pred: torch.Tensor, truth: torch.Tensor, mask: torch.Tensor,
                max_val: float = 1.0) -> torch.Tensor:
    """PSNR over the UNSCANNED region only, per image of a (..., H, W)
    batch (scanned pixels are copied through and would inflate it)."""
    w = 1.0 - mask.to(torch.float32)
    mse = torch.sum(w * (pred - truth) ** 2, dim=(-2, -1)) / torch.clamp(
        torch.sum(w), min=1.0)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


FILLS = {
    "normconv_s2": lambda x, m: normconv_fill(x, m, 2.0),
    "normconv_s4": lambda x, m: normconv_fill(x, m, 4.0),
    "normconv_s8": lambda x, m: normconv_fill(x, m, 8.0),
    "nearest": nearest_fill,
    "harmonic": harmonic_fill,
}


def compare_infills(masked: torch.Tensor, clean: torch.Tensor,
                    mask: torch.Tensor, nn_fn=None, max_val: float = 1.0
                    ) -> dict[str, dict[str, float]]:
    """Score the classical fills (and optionally the NN) on a batch of
    partial scans. `masked` / `clean`: (n, h, w) in one value range on one
    device; `mask`: (h, w) bool. Returns {name: {"psnr_masked": ...}},
    each the mean over images of the per-image masked PSNR."""
    mask = mask.to(masked.device)
    out: dict[str, dict[str, float]] = {}
    with torch.no_grad():
        for name, fn in FILLS.items():
            score = masked_psnr(fn(masked, mask), clean, mask, max_val)
            out[name] = {"psnr_masked": float(torch.mean(score))}
        if nn_fn is not None:
            score = masked_psnr(nn_fn(masked), clean, mask, max_val)
            out["nn"] = {"psnr_masked": float(torch.mean(score))}
    return out

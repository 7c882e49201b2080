"""Degradation synthesis for training (port of the denoiser's part of
emx/data/degrade.py), batched: every function takes a whole (B, H, W)
batch on its device.

  * Poisson low-dose with scale ~ 25 + 75 * Exponential(1) counts per
    pixel (reference misc_py/denoiser-multi-gpu.py:785-799), drawn by the
    fused degrade kernel (emx_torch/ops/degrade_kernel.py).

Randomness comes from an explicit seed: a `torch.Generator` on the
batch's device for the D4 choices and dose scales, and a derived 64-bit
seed for the kernel's Philox stream. The trainer derives the seed from
(TrainConfig.seed, step).

`gaussian_blur` (separable, zero padding) serves the classical filters
(emx_torch.analysis.filters). Masks, occlusion and downsampling are not
ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emx_torch.ops.degrade_kernel import fused_poisson_degrade
from emx_torch.utils.image import flip_rotate, sanitize, scale0to1
from emx_torch.utils.rng import fold_in


def sample_dose_scale(generator: torch.Generator, n: int,
                      base: float = 25.0, mean: float = 75.0) -> torch.Tensor:
    """n scales base + mean * Exponential(1), on the generator's device."""
    e = torch.empty(n, device=generator.device).exponential_(
        1.0, generator=generator)
    return base + mean * e


def poisson_dose(seed: int, imgs: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """Low-dose images: Poisson(img * scale) shot noise, rescaled to [0, 1]
    per image."""
    return fused_poisson_degrade(seed, imgs, scales)


def denoiser_example(seed: int, imgs: torch.Tensor):
    """A batch of (noisy, target) training pairs with the reference's
    recipe (denoiser-multi-gpu.py record_parser:861-876): sanitize ->
    scale0to1 -> a random D4 transform per image -> Poisson at a sampled
    dose; the target is the clean image rescaled to its noisy image's
    mean. `imgs` (B, H, H) float32."""
    gen = torch.Generator(device=imgs.device)
    gen.manual_seed(fold_in(seed, 0))
    b = imgs.shape[0]
    imgs = scale0to1(sanitize(imgs), dim=(-2, -1))
    imgs = flip_rotate(imgs, torch.randint(0, 8, (b,), generator=gen,
                                           device=imgs.device))
    scales = sample_dose_scale(gen, b)
    lq = poisson_dose(fold_in(seed, 1), imgs, scales)
    ratio = lq.mean(dim=(-2, -1), keepdim=True) / torch.clamp(
        imgs.mean(dim=(-2, -1), keepdim=True), min=1e-12)
    return lq, imgs * ratio


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of the last two dims, zero padding (SAME),
    float32. Sums of shifted copies: exact float32 on every device, where
    a cuDNN convolution may take TF32."""
    radius = radius or max(1, int(3 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / torch.sum(k)
    h, w = img.shape[-2:]
    p = F.pad(img, (0, 0, radius, radius))
    out = sum(k[i] * p[..., i:i + h, :] for i in range(2 * radius + 1))
    p = F.pad(out, (radius, radius))
    return sum(k[i] * p[..., i:i + w] for i in range(2 * radius + 1))

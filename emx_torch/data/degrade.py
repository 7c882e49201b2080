"""Degradation synthesis for training (port of the denoiser's part of
emx/data/degrade.py), batched: every function takes a whole (B, H, W)
batch on its device.

  * Poisson low-dose with scale ~ 25 + 75 * Exponential(1) counts per
    pixel (reference misc_py/denoiser-multi-gpu.py:785-799), drawn by the
    fused degrade kernel (emx_torch/ops/degrade_kernel.py).

Randomness comes from an explicit seed, and an example function comes in
two halves (`SplitExample`) so that a CUDA graph of the train step can
replay it: `draws(seed, b, device)` draws every random value a step
needs (the D4 choices and the dose scales from a generator on `device`
seeded by the seed, and the degrade kernel's 64-bit Philox key, as a
tensor there); `apply(draws, imgs)` then runs on the batch's device and
reads nothing but tensors. The trainer derives the seed from
(TrainConfig.seed, step); for a graph it draws before each replay and
hands the draws in through pinned buffers, so an eager step and a
replayed one see the same values, and both see what eager steps saw
before graphs existed.

`gaussian_blur` (separable, zero padding) serves the classical filters
(emx_torch.analysis.filters). Masks, occlusion and downsampling are not
ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from emx_torch.ops.degrade_kernel import fused_poisson_degrade, seed_tensor
from emx_torch.utils.image import flip_rotate, sanitize, scale0to1
from emx_torch.utils.rng import fold_in


def sample_dose_scale(generator: torch.Generator, n: int,
                      base: float = 25.0, mean: float = 75.0) -> torch.Tensor:
    """n scales base + mean * Exponential(1), on the generator's device."""
    e = torch.empty(n, device=generator.device).exponential_(
        1.0, generator=generator)
    return base + mean * e


def poisson_dose(seed, imgs: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """Low-dose images: Poisson(img * scale) shot noise, rescaled to [0, 1]
    per image. `seed` as fused_poisson_degrade takes it."""
    return fused_poisson_degrade(seed, imgs, scales)


@dataclasses.dataclass(frozen=True)
class SplitExample:
    """An example function (seed, clean batch) -> (inputs, targets) in two
    halves: `draws(seed, b, device)` -> dict of tensors on `device`;
    `apply(draws, imgs)` -> (inputs, targets) on the batch's device,
    reading only tensors (so that a CUDA graph can capture it). Calling
    it runs both."""

    draws: Callable[[int, int, torch.device], dict[str, torch.Tensor]]
    apply: Callable[[dict[str, torch.Tensor], torch.Tensor], tuple]

    def __call__(self, seed: int, imgs: torch.Tensor):
        return self.apply(self.draws(seed, imgs.shape[0], imgs.device), imgs)


def denoiser_draws(seed: int, b: int, device: torch.device | str = "cpu"
                   ) -> dict[str, torch.Tensor]:
    """One step's random values for `b` images on `device`: a D4 choice
    and a dose scale per image from a generator there seeded by
    fold_in(seed, 0), and the degrade kernel's key fold_in(seed, 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_in(seed, 0))
    d4 = torch.randint(0, 8, (b,), generator=gen, device=device)
    return {"d4": d4, "scales": sample_dose_scale(gen, b),
            "key": seed_tensor(fold_in(seed, 1), device)}


def denoiser_apply(draws: dict[str, torch.Tensor], imgs: torch.Tensor):
    """A batch of (noisy, target) training pairs with the reference's
    recipe (denoiser-multi-gpu.py record_parser:861-876): sanitize ->
    scale0to1 -> a D4 transform per image -> Poisson at its dose; the
    target is the clean image rescaled to its noisy image's mean. `imgs`
    (B, H, H) float32; `draws` on its device."""
    imgs = scale0to1(sanitize(imgs), dim=(-2, -1))
    imgs = flip_rotate(imgs, draws["d4"])
    lq = poisson_dose(draws["key"], imgs, draws["scales"])
    ratio = lq.mean(dim=(-2, -1), keepdim=True) / torch.clamp(
        imgs.mean(dim=(-2, -1), keepdim=True), min=1e-12)
    return lq, imgs * ratio


denoiser_example = SplitExample(denoiser_draws, denoiser_apply)


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

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
before graphs existed. `SplitExample.shard(block, blocks, runs)` is the
example function of a data-parallel rank's rows of a global batch (row
block `block` of `blocks` of each of `runs` microbatches): it draws for
the global batch and keeps its rows, and the degrade kernel counts each
run's images from its first global row, so the rows come out as the
global batch's do.

The partial-scan infilling GAN's examples
(reference gan-infilling-100.py:1147-1192): fixed Bernoulli scan masks
drawn with numpy's legacy RandomState (bit-exact with emx's, so a mask
is the same on every machine), the -1 fill of unscanned pixels, the
[-1, 1] normalisation, and `infilling_example(mask)`, a SplitExample
whose draws are one D4 choice per image. `occlude` (large occlusions,
adversarial_micrograph_gen.py:956-990) takes its draws from
`occlude_draws`, `box_downsample` averages integer blocks.

`gaussian_blur` (separable, zero padding) serves the classical filters
(emx_torch.analysis.filters).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np

import torch
import torch.nn.functional as F

from emx_torch.ops.degrade_kernel import fused_poisson_degrade, seed_tensor
from emx_torch.parallel.mesh import microbatch_rows
from emx_torch.utils.image import flip_rotate, sanitize, scale0to1
from emx_torch.utils.rng import fold_in


def sample_dose_scale(generator: torch.Generator, n: int,
                      base: float = 25.0, mean: float = 75.0) -> torch.Tensor:
    """n scales base + mean * Exponential(1), on the generator's device."""
    e = torch.empty(n, device=generator.device).exponential_(
        1.0, generator=generator)
    return base + mean * e


def poisson_dose(seed, imgs: torch.Tensor, scales: torch.Tensor,
                 image_offset: int = 0) -> torch.Tensor:
    """Low-dose images: Poisson(img * scale) shot noise, rescaled to [0, 1]
    per image. `seed` and `image_offset` as fused_poisson_degrade takes
    them."""
    return fused_poisson_degrade(seed, imgs, scales, image_offset)


# Draws that are one value for the whole batch; every other draw holds
# one row per image.
SHARED_DRAWS = ("key",)


@dataclasses.dataclass(frozen=True)
class SplitExample:
    """An example function (seed, clean batch) -> (inputs, targets) in two
    halves: `draws(seed, b, device)` -> dict of tensors on `device`;
    `apply(draws, imgs, image_offset=0)` -> (inputs, targets) on the
    batch's device, reading only tensors (so that a CUDA graph can capture
    it). Calling it runs both."""

    draws: Callable[[int, int, torch.device], dict[str, torch.Tensor]]
    apply: Callable[..., tuple]

    def __call__(self, seed: int, imgs: torch.Tensor):
        return self.apply(self.draws(seed, imgs.shape[0], imgs.device), imgs)

    def shard(self, block: int, blocks: int, runs: int = 1
              ) -> "SplitExample":
        """This example for a data-parallel rank's rows of a global batch
        (emx_torch.parallel.mesh.microbatch_rows): `draws(seed, b,
        device)` draws for the b * blocks images and keeps those rows
        (the shared draws whole), and `apply` degrades each run at the
        global index of its first image (one launch a run)."""
        if not 0 <= block < blocks:
            raise ValueError(f"block {block} of {blocks}")
        if blocks == 1:
            return self
        return SplitExample(
            functools.partial(_block_draws, self.draws, block, blocks, runs),
            functools.partial(_block_apply, self.apply, block, blocks, runs))


def _block_draws(draws, block: int, blocks: int, runs: int, seed: int,
                 b: int, device) -> dict[str, torch.Tensor]:
    d = draws(seed, b * blocks, device)
    return {k: v if k in SHARED_DRAWS else
            microbatch_rows(v, block, blocks, runs) for k, v in d.items()}


def _block_apply(apply, block: int, blocks: int, runs: int,
                 draws: dict[str, torch.Tensor], imgs: torch.Tensor):
    c = imgs.shape[0] // runs
    outs = [apply({k: v if k in SHARED_DRAWS else v[m * c:(m + 1) * c]
                   for k, v in draws.items()}, imgs[m * c:(m + 1) * c],
                  image_offset=(m * blocks + block) * c)
            for m in range(runs)]
    if runs == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


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


def denoiser_apply(draws: dict[str, torch.Tensor], imgs: torch.Tensor,
                   image_offset: int = 0):
    """A batch of (noisy, target) training pairs with the reference's
    recipe (denoiser-multi-gpu.py record_parser:861-876): sanitize ->
    scale0to1 -> a D4 transform per image -> Poisson at its dose; the
    target is the clean image rescaled to its noisy image's mean. `imgs`
    (B, H, H) float32; `draws` on its device; `image_offset` the batch's
    first row in a global batch (the degrade kernel's)."""
    imgs = scale0to1(sanitize(imgs), dim=(-2, -1))
    imgs = flip_rotate(imgs, draws["d4"])
    lq = poisson_dose(draws["key"], imgs, draws["scales"], image_offset)
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


def bernoulli_mask(generator: torch.Generator, shape: tuple[int, int],
                   coverage: float) -> torch.Tensor:
    """Boolean scan mask with a `coverage` fraction of pixels selected,
    drawn on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u < coverage


def fixed_scan_mask(shape: tuple[int, int] = (512, 512),
                    coverage: float = 1 / 64, seed: int = 1,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """The reference's fixed training mask (np.random.seed(1), then
    uniform < coverage; gan-infilling-100.py:1173-1175), bit-exact with
    numpy's legacy RandomState, as emx draws it."""
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.random_sample(shape) < coverage).to(device)


def apply_partial_scan(img: torch.Tensor, mask: torch.Tensor,
                       fill: float = -1.0) -> torch.Tensor:
    """Unscanned pixels take `fill` (-1 in the reference, outside data
    normalised to [-1, 1])."""
    return torch.where(mask, img, torch.full_like(img, fill))


def norm_neg1to1(img: torch.Tensor, dim=(-2, -1)) -> torch.Tensor:
    """Rescale to [-1, 1] over `dim`; constant images map to 0
    (reference gan-infilling-100.py norm_img:1147-1160)."""
    lo = torch.amin(img, dim=dim, keepdim=True)
    hi = torch.amax(img, dim=dim, keepdim=True)
    a = 0.5 * (lo + hi)
    b = 0.5 * (hi - lo)
    ok = b > 5e-7
    return torch.where(ok, (img - a) / torch.where(ok, b, torch.ones_like(b)),
                       torch.zeros_like(img))


def infilling_draws(seed: int, b: int, device: torch.device | str = "cpu"
                    ) -> dict[str, torch.Tensor]:
    """One step's random values for `b` images: a D4 choice per image
    from a generator on `device` seeded by fold_in(seed, 0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_in(seed, 0))
    return {"d4": torch.randint(0, 8, (b,), generator=gen, device=device)}


def infilling_apply(draws: dict[str, torch.Tensor], imgs: torch.Tensor,
                    mask: torch.Tensor, image_offset: int = 0):
    """A batch of (partial scan, full) GAN-infilling pairs
    (gan-infilling-100.py record_parser:1184-1192): sanitize (NaN -> 0)
    -> [-1, 1] -> a D4 transform per image -> the scan mask's -1 fill.
    Nothing here counts images, so `image_offset` moves nothing."""
    imgs = norm_neg1to1(sanitize(imgs, 0.0))
    imgs = flip_rotate(imgs, draws["d4"])
    return apply_partial_scan(imgs, mask.to(imgs.device)), imgs


def infilling_example(mask: torch.Tensor) -> SplitExample:
    """The infilling example function for scan mask `mask` (emx's
    functools.partial(infilling_example, mask=mask))."""
    return SplitExample(infilling_draws,
                        functools.partial(infilling_apply, mask=mask))


def occlude_draws(generator: torch.Generator, b: int, n: int
                  ) -> dict[str, torch.Tensor]:
    """Per image of a batch of `b` n x n images: the occlusion's kind (0
    centred rectangle, 1 side block, 2 corner), its two half sizes, the
    side block's size and a D4 choice, on the generator's device."""
    dev = generator.device

    def ints(hi):
        return torch.randint(0, hi, (b,), generator=generator, device=dev)

    return {"choice": ints(3), "half1": ints(n // 2 + 1) // 2,
            "half2": ints(n // 2 + 1) // 2, "side": ints(n + 1),
            "d4": ints(8)}


def occlude(imgs: torch.Tensor, draws: dict[str, torch.Tensor],
            mark: float = 0.5) -> torch.Tensor:
    """Large occlusions of a (B, n, n) batch: a centred rectangle, an
    axis-aligned side block or a corner block set to `mark`, then a D4
    transform (adversarial_micrograph_gen.py gen_lq:956-990)."""
    n = imgs.shape[-1]
    d = {k: v.to(imgs.device)[:, None, None] for k, v in draws.items()}
    rows = torch.arange(n, device=imgs.device)[None, :, None]
    cols = torch.arange(n, device=imgs.device)[None, None, :]
    h1, h2 = d["half1"], d["half2"]
    center = ((rows >= h1) & (rows < n - h1)
              & (cols >= h2) & (cols < n - h2))
    side = (rows < d["side"]) & (cols < d["side"])
    corner = (rows < h1) & (cols < h2)
    choice = d["choice"]
    mask = torch.where(choice == 0, center,
                       torch.where(choice == 1, side, corner))
    out = torch.where(mask, torch.full_like(imgs, mark), imgs)
    return flip_rotate(out, draws["d4"])


def box_downsample(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Box (area-average) downsampling of the last two dims by an integer
    factor, MATLAB imresize 'box' semantics (img_params.m:31)."""
    *lead, h, w = img.shape
    if h % factor or w % factor:
        raise ValueError(f"size {h}x{w} does not divide factor {factor}")
    r = img.reshape(*lead, h // factor, factor, w // factor, factor)
    return r.mean(dim=(-3, -1))

"""Micrograph statistics suite (port of emx/physics/stats.py), on
tensors of any device and batched: every function takes one image
(S, S) or a batch (B, S, S) of square images.

  * `estimate_noise`: Laplacian-convolution noise sigma
    (reference DM3stoTIFs-batch/estimate_noise.m:1-12),
  * `radial_fft_profile`: radially-binned FFT magnitude profile
    (reference DM3stoTIFs-batch/img_params.m:53-70), on `torch.fft`,
  * `image_stats`: the 40-statistic "compendium" record per image
    (reference DM3stoTIFs-batch/img_params.m:1-119).

The 3x3 convolution is written as nine shifted sums, exact float32 on
every device (a cuDNN float32 convolution may take TF32 on the card).
Sums run in other orders than XLA's, so the statistics agree with emx's
to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LAPLACE2 = ((1.0, -2.0, 1.0), (-2.0, 4.0, -2.0), (1.0, -2.0, 1.0))


def estimate_noise(img: torch.Tensor) -> torch.Tensor:
    """Noise sigma via sum(|img * Laplacian-of-Laplacian|) over the 'full'
    convolution (MATLAB conv2's default), scaled by the interior size."""
    img = img.float()
    h, w = img.shape[-2], img.shape[-1]
    p = F.pad(img, (2, 2, 2, 2))
    out = 0.0
    # Full convolution: out[y, x] = sum_{i,j} k[i, j] img[y - i, x - j];
    # the kernel is symmetric, so correlation and convolution agree.
    for i in range(3):
        for j in range(3):
            out = out + _LAPLACE2[i][j] * p[..., i:i + h + 2, j:j + w + 2]
    sigma = torch.sum(torch.abs(out), dim=(-2, -1))
    return sigma * (math.sqrt(0.5 * math.pi) / (6.0 * (w - 2) * (h - 2)))


def _moments(x: torch.Tensor, image: bool = True):
    """mean, std (ddof=0), skewness, kurtosis (non-excess) over each
    image's two last dims (`image`) or over the last dim (a profile)."""
    x = x.flatten(-2) if image else x
    mean = x.mean(-1)
    c = x - mean[..., None]
    var = (c ** 2).mean(-1)
    std = torch.sqrt(var)
    safe = torch.clamp(std, min=1e-20)
    skew = (c ** 3).mean(-1) / safe ** 3
    kurt = (c ** 4).mean(-1) / torch.clamp(var, min=1e-30) ** 2
    return mean, std, skew, kurt


def radial_fft_profile(img: torch.Tensor, num_bins: int | None = None):
    """Radially-binned |fftshift(fft2(img))| profile, normalised to sum 1
    then weighted by bin frequency (img_params.m:53-70). Returns
    (profile, freqs), each (..., num_bins). Bin = ceil(radius)."""
    n = img.shape[-1]
    mid = n // 2
    max_radius = int(math.ceil(math.sqrt(2) * (mid + 1)))
    num_bins = num_bins or max_radius
    mag = torch.fft.fftshift(torch.fft.fft2(img.float()),
                             dim=(-2, -1)).abs()
    yy = torch.arange(n, dtype=torch.float32, device=img.device) - mid
    r = torch.sqrt(yy[:, None] ** 2 + yy[None, :] ** 2)
    idx = torch.ceil(r).long().reshape(-1)
    lead = mag.shape[:-2]
    flat = mag.reshape(-1, n * n)
    profile = torch.zeros(flat.shape[0], num_bins, device=img.device)
    profile.index_add_(1, idx, flat)
    # Bins beyond the corner radius are empty: their frequency is 0.
    freqs = torch.zeros(num_bins, device=img.device).scatter_reduce(
        0, idx, (r / max_radius).reshape(-1), "amax", include_self=False)
    profile = profile / profile.sum(-1, keepdim=True)
    return (profile * freqs).reshape(*lead, num_bins), freqs


STAT_NAMES = (
    # Raw-image stats (img_params.m:7-21, computed BEFORE the resize):
    "smallest_dim", "height", "width", "num_px",
    "min", "max", "num_nonzero", "proportion_zero", "num_negative",
    "proportion_negative",
    # Resized (2048) stats (img_params.m:34-51):
    "noise", "mean", "stddev", "skewness", "kurtosis",
    "min_resized", "max_resized",
    "median", "coeff_variation", "rms",
    "mean_freq", "stddev_freq", "skewness_freq", "kurtosis_freq",
    "mean_noise_gauss", "stddev_noise_gauss", "skewness_noise_gauss",
    "kurtosis_noise_gauss", "ratio_mean_noise_to_mean",
    "noise_0to1", "mean_0to1", "stddev_0to1", "median_0to1",
    "coeff_variation_0to1", "rms_0to1",
    "mean_noise_gauss_0to1", "stddev_noise_gauss_0to1",
    "skewness_noise_gauss_0to1", "kurtosis_noise_gauss_0to1",
    "ratio_mean_noise_to_mean_0to1",
)


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median over the last two dims: the mean of the two middle
    values of an even count (torch.median takes the lower one)."""
    flat = x.flatten(-2)
    n = flat.shape[-1]
    s = torch.sort(flat, dim=-1).values
    if n % 2:
        return s[..., n // 2]
    return (s[..., n // 2 - 1] + s[..., n // 2]) / 2


def image_stats(img: torch.Tensor, raw: torch.Tensor | None = None
                ) -> dict[str, torch.Tensor]:
    """The reference's full per-image statistics compendium (all 40
    img_params.m fields, in STAT_NAMES order) of square, already resized
    images (S, S) or (B, S, S); each value is 0-dim or (B,).

    `raw` is the pre-resize image the dimension/extrema/zero-count stats
    are computed from (img_params.m:7-21 runs them before the resize);
    when omitted, `img` stands in for both. For a corpus of many raw
    shapes compute those on the host (emx_torch.data.harvest.raw_stats).
    """
    img = img.float()
    ref = img if raw is None else raw.float()
    lead = img.shape[:-2]
    n_px = ref.shape[-2] * ref.shape[-1]
    const = lambda v: torch.full(lead, float(v), device=img.device)  # noqa: E731
    out: dict[str, torch.Tensor] = {}
    out["smallest_dim"] = const(min(ref.shape[-2:]))
    out["height"] = const(ref.shape[-2])
    out["width"] = const(ref.shape[-1])
    out["num_px"] = const(n_px)
    out["min"] = torch.amin(ref, dim=(-2, -1))
    out["max"] = torch.amax(ref, dim=(-2, -1))
    out["num_nonzero"] = (ref != 0).sum((-2, -1)).float()
    out["proportion_zero"] = out["num_nonzero"] / n_px
    out["num_negative"] = (ref < 0).sum((-2, -1)).float()
    out["proportion_negative"] = out["num_negative"] / n_px

    out["noise"] = estimate_noise(img)
    mean, std, skew, kurt = _moments(img)
    out["mean"], out["stddev"], out["skewness"], out["kurtosis"] = (
        mean, std, skew, kurt)
    out["min_resized"] = torch.amin(img, dim=(-2, -1))
    out["max_resized"] = torch.amax(img, dim=(-2, -1))
    out["median"] = _median(img)
    out["coeff_variation"] = 100.0 * std / mean
    out["rms"] = torch.sqrt((img ** 2).mean((-2, -1)))

    profile, _ = radial_fft_profile(img)
    _, fstd, fskew, fkurt = _moments(profile, image=False)
    out["mean_freq"] = profile.sum(-1)
    out["stddev_freq"], out["skewness_freq"], out["kurtosis_freq"] = (
        fstd, fskew, fkurt)

    # sqrt-image "noise from Gauss" moments (Poisson -> approx Gaussian).
    gmean, gstd, gskew, gkurt = _moments(torch.sqrt(torch.clamp(img,
                                                                min=0.0)))
    out["mean_noise_gauss"] = gmean
    out["stddev_noise_gauss"] = gstd
    out["skewness_noise_gauss"] = gskew
    out["kurtosis_noise_gauss"] = gkurt
    out["ratio_mean_noise_to_mean"] = gmean / mean

    # Repeat for the 0-1 rescaled copy (the RESIZED extrema,
    # img_params.m:80).
    lo = out["min_resized"][..., None, None]
    span = torch.clamp(out["max_resized"] - out["min_resized"],
                       min=1e-20)[..., None, None]
    img01 = (img - lo) / span
    out["noise_0to1"] = estimate_noise(img01)
    m1, s1, _, _ = _moments(img01)
    out["mean_0to1"], out["stddev_0to1"] = m1, s1
    out["median_0to1"] = _median(img01)
    out["coeff_variation_0to1"] = 100.0 * s1 / m1
    out["rms_0to1"] = torch.sqrt((img01 ** 2).mean((-2, -1)))
    g1mean, g1std, g1skew, g1kurt = _moments(torch.sqrt(torch.clamp(
        img01, min=0.0)))
    out["mean_noise_gauss_0to1"] = g1mean
    out["stddev_noise_gauss_0to1"] = g1std
    out["skewness_noise_gauss_0to1"] = g1skew
    out["kurtosis_noise_gauss_0to1"] = g1kurt
    out["ratio_mean_noise_to_mean_0to1"] = g1mean / m1
    return out

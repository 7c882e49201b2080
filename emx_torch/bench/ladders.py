"""The flagship's five evaluation ladders, rebuilt on a device (the
port of emx/bench/quant_check.py:_val_ladder and _ood_ladder).

emx draws each ladder's shot noise with `jax.random.poisson`, which the
port cannot reproduce; scripts/make_port_ladders.py draws the counts
with emx once and commits them (`LADDERS`, uint8). Here the clean images
are made again from their seeds (numpy, or for ood_ctf numpy and
torch.fft), checked against the recorded hash, and the ladder follows
emx's recipe per image:

  img = scale0to1(sanitize(clean)); lq = scale0to1(counts)
  tgt = img * mean(lq) / max(mean(img), 1e-12)

Each family: 32 images of 512x512 at doses linspace(25, 150, 32);
clean seeds val 999 (synthetic), ctf 555, grains 321, filaments 777,
porous 444.

The record is a fingerprint, not a hash: the file also keeps the
sha256 of emx's images, but float rounding of the same numpy code
differs between machines (porous_micrographs, float32 FFT and tanh,
gave other bits on the H100's machine, numpy 2.3.5, than where the
file was written, numpy 2.0.2), and ctf renders on torch.fft. So each image's mean, mean
square and projection on a fixed +-1 pattern must agree with the
record within `FINGERPRINT_TOL`; another seed or family misses by
~1e-2.
"""

from __future__ import annotations


import numpy as np
import torch

from emx_torch.data.pipeline import (ctf_lattice, filament_micrographs,
                                     grain_micrographs, porous_micrographs,
                                     render_ctf, synthetic_micrographs)
from emx_torch.utils.device import resolve_device
from emx_torch.utils.image import sanitize, scale0to1

LADDERS = "docs/runs/port_ladders/ladders.npz"
FAMILIES = ("val", "ood_ctf", "ood_grains", "ood_filaments", "ood_porous")
# family -> numpy generator of the clean images (ctf: of its lattice).
_SOURCES = {"val": synthetic_micrographs, "ood_ctf": ctf_lattice,
            "ood_grains": grain_micrographs,
            "ood_filaments": filament_micrographs,
            "ood_porous": porous_micrographs}
SEEDS = {"val": 999, "ood_ctf": 555, "ood_grains": 321,
         "ood_filaments": 777, "ood_porous": 444}
FINGERPRINT_TOL = 1e-5


def clean_images(family: str, n: int = 32, size: int = 512,
                 seed: int | None = None,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """(n, size, size) float32 clean images of `family` on `device`."""
    seed = SEEDS[family] if seed is None else seed
    out = _SOURCES[family](n, size, seed=seed)
    if family == "ood_ctf":
        return render_ctf(*(torch.from_numpy(a).to(device) for a in out))
    return torch.from_numpy(out).to(device)


def fingerprint(imgs: torch.Tensor) -> torch.Tensor:
    """(n, 3) float64 per image: mean, mean square, and mean of the image
    times a fixed +-1 pattern."""
    x = imgs.double()
    sign = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, imgs.shape[-2:]) * 2.0 - 1.0).to(x.device)
    return torch.stack([x.mean(dim=(-2, -1)), (x * x).mean(dim=(-2, -1)),
                        (x * sign).mean(dim=(-2, -1))], dim=-1)


def rebuild(clean: torch.Tensor, counts: torch.Tensor):
    """(noisy, target) from clean images and their Poisson counts,
    emx's recipe per image."""
    img = scale0to1(sanitize(clean.float()), dim=(-2, -1))
    lq = scale0to1(counts.float(), dim=(-2, -1))
    ratio = lq.mean(dim=(-2, -1), keepdim=True) / torch.clamp(
        img.mean(dim=(-2, -1), keepdim=True), min=1e-12)
    return lq, img * ratio


def ladder_record(family: str, path: str | None = None) -> dict:
    """What the ladder file (`LADDERS` unless `path` names another)
    records for `family` (numpy): counts, doses, seed, the fingerprint
    and sha256 of emx's clean images, and emx's per-image identity
    PSNR."""
    with np.load(path or LADDERS) as z:
        return {k: z[f"{family}_{k}"] for k in
                ("counts", "doses", "seed", "fingerprint", "sha256",
                 "identity_psnr")}


def load_ladder(family: str, device: str | torch.device = "cuda",
                path: str | None = None):
    """(noisy, target), (32, 512, 512) float32 on `device`. Raises
    ValueError when the file's counts do not have the doses' shape or
    the clean images made here miss the recorded fingerprint."""
    device = resolve_device(device)
    rec = ladder_record(family, path)
    counts = rec["counts"]
    n = len(rec["doses"])
    if counts.ndim != 3 or counts.shape[0] != n or \
            counts.shape[1] != counts.shape[2]:
        raise ValueError(f"{family}: counts of shape {counts.shape} for "
                         f"{n} doses")
    clean = clean_images(family, n, counts.shape[-1], int(rec["seed"]),
                         device)
    miss = float((fingerprint(clean).cpu() - torch.from_numpy(
        rec["fingerprint"])).abs().max())
    if miss > FINGERPRINT_TOL:
        raise ValueError(f"{family}: the clean images miss the ladder "
                         f"file's fingerprint by {miss:.2e}")
    return rebuild(clean, torch.from_numpy(counts).to(device))


def val_ladder(device: str | torch.device = "cuda",
               path: str | None = None):
    return load_ladder("val", device, path)


def ood_ladder(family: str, device: str | torch.device = "cuda",
               path: str | None = None):
    """family: "ctf", "grains", "filaments" or "porous"."""
    return load_ladder(f"ood_{family}", device, path)


def per_image_psnr(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """(B,) PSNR of each image of [0, 1] batches, as emx's vmap(psnr)."""
    mse = torch.mean((pred.float() - truth.float()) ** 2, dim=(-2, -1))
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))


def mean_psnr(pred: torch.Tensor, truth: torch.Tensor) -> float:
    """emx's quant_check._psnr: the mean per-image PSNR, to 3 places."""
    return round(float(per_image_psnr(pred, truth).mean()), 3)

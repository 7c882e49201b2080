"""Serving-time denoiser selection without ground truth (J-invariant;
port of emx/serve/select.py).

The Noise2Self J-invariant risk (Batson & Royer, ICML 2019) ranks
denoisers on the noisy frame alone: mask a random pixel subset, replace
each masked pixel by the mean of its unmasked 3x3 neighbours, denoise
the masked frame, and score the prediction against the original noisy
values on the masked set only. For pixel-independent noise (Poisson
shot noise) the masked-set MSE ranks denoisers by true MSE up to the
noise variance.

`auto_denoise` runs every candidate once on each masked frame (scores)
and once on the frame itself, and keeps each image's winner. Masks come
from `torch.Generator`s seeded per candidate from one integer seed, so
they differ from emx's `jax.random` masks; `masked_score` takes the
masks themselves, which is what the tests hold against emx.
`SERVING_CANDIDATES` is the candidate list that auto-select serving and
emx_torch.bench.auto_select_check share.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from emx_torch.analysis.filters import (chambolle_tv, gaussian_filter,
                                        median_filter, wiener_filter)
from emx_torch.utils.rng import fold_in

Denoise = Callable[[torch.Tensor], torch.Tensor]

# The classical candidates next to the NN, by name, as emx serves them.
SERVING_FILTERS: tuple[tuple[str, Denoise], ...] = (
    ("gaussian", lambda x: gaussian_filter(x, 1.0)),
    ("median", lambda x: median_filter(x, 1)),
    ("wiener", lambda x: wiener_filter(x, 1)),
    ("tv", lambda x: chambolle_tv(x, 0.1)),
)


def serving_candidates(nn_fn: Denoise) -> tuple[list[str], list[Denoise]]:
    """(names, candidates): the NN (float32 out) first, then the filters."""
    names = ["nn"] + [n for n, _ in SERVING_FILTERS]
    fns = [lambda x: nn_fn(x).float()] + [f for _, f in SERVING_FILTERS]
    return names, fns


def _neighbour_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of each pixel's eight 3x3 neighbours, zero outside the image:
    emx's convolve2d(x, ones(3, 3) with a zero centre, "same")."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    return sum(p[..., dy:dy + h, dx:dx + w]
               for dy in range(3) for dx in range(3) if (dy, dx) != (1, 1))


def _masked_replace(noisy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace masked pixels of (..., H, W) with the mean of their
    unmasked 3x3 neighbours (the masked pixel never reaches the
    denoiser)."""
    keep = (~mask).to(noisy.dtype)
    num = _neighbour_sum(noisy * keep)
    den = torch.clamp(_neighbour_sum(keep), min=1.0)
    return torch.where(mask, num / den, noisy)


def masked_score(denoise_fn: Denoise, noisy: torch.Tensor,
                 masks: torch.Tensor) -> torch.Tensor:
    """Mean masked-pixel MSE of `denoise_fn` on a (B, H, W) batch over
    the boolean masks (n_masks, B, H, W). Returns (B,); lower is
    better."""
    ref = noisy.float()
    scores = []
    for mask in masks:
        pred = denoise_fn(_masked_replace(noisy, mask)).float()
        m = mask.float()
        err = (pred - ref) ** 2 * m
        scores.append(torch.sum(err, dim=(-2, -1))
                      / torch.clamp(torch.sum(m, dim=(-2, -1)), min=1.0))
    return torch.stack(scores).mean(dim=0)


def random_masks(noisy: torch.Tensor, seed: int, n_masks: int,
                 frac: float) -> torch.Tensor:
    """(n_masks, B, H, W) Bernoulli(frac) masks from a generator on the
    batch's device seeded with `seed`."""
    gen = torch.Generator(device=noisy.device)
    gen.manual_seed(seed)
    u = torch.rand((n_masks, *noisy.shape), generator=gen,
                   device=noisy.device)
    return u < frac


def j_invariant_score(denoise_fn: Denoise, noisy: torch.Tensor, seed: int,
                      n_masks: int = 4, frac: float = 0.02) -> torch.Tensor:
    """`masked_score` over `n_masks` random masks of `frac` of the pixels.
    The ranking is unbiased for pixel-independent noise; the value
    includes the noise variance, the same for every candidate."""
    return masked_score(denoise_fn, noisy,
                        random_masks(noisy, seed, n_masks, frac))


def auto_denoise(noisy: torch.Tensor, candidates: Sequence[Denoise],
                 seed: int, n_masks: int = 4, frac: float = 0.02
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Denoise (B, H, W) with each image's J-invariant winner among
    `candidates`. Returns (output, chosen), chosen the (B,) index of the
    winning candidate; candidate i draws its masks from fold_in(seed, i)."""
    with torch.inference_mode():
        scores = torch.stack([
            j_invariant_score(fn, noisy, fold_in(seed, i), n_masks, frac)
            for i, fn in enumerate(candidates)])          # (n_cand, B)
        chosen = torch.argmin(scores, dim=0)              # (B,)
        outs = torch.stack([fn(noisy).float() for fn in candidates])
        out = torch.take_along_dim(outs, chosen[None, :, None, None],
                                   dim=0)[0]
    return out.to(noisy.dtype), chosen

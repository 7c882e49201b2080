"""Analysis statistics (port of emx/analysis/stats.py): image entropy,
Gram matrices, Gram histograms, on tensors of any device.

Rebuilds misc_py/entropy.py (Shannon entropy over intensity histograms)
and misc_py/img_stats.py + gram_hist.py (feature Gram matrices used to
characterise micrograph texture).
"""

from __future__ import annotations

import torch


def _histogram(x: torch.Tensor, num_bins: int):
    """Counts of `x` in num_bins equal bins over [min, max] (the top
    value in the last bin), and the bins' low edge and width."""
    lo, hi = torch.min(x), torch.max(x)
    span = torch.clamp(hi - lo, min=1e-12)
    idx = torch.clamp(((x - lo) / span * num_bins).to(torch.int32),
                      0, num_bins - 1)
    counts = torch.bincount(idx.reshape(-1).long(), minlength=num_bins)
    return counts.to(x.dtype), lo, span


def shannon_entropy(img: torch.Tensor, num_bins: int = 256) -> torch.Tensor:
    """Entropy (bits) of the intensity histogram (misc_py/entropy.py)."""
    img = img.float()
    counts, _, _ = _histogram(img, num_bins)
    p = counts / img.numel()
    return -torch.sum(torch.where(
        p > 0, p * torch.log2(torch.clamp(p, min=1e-12)),
        torch.zeros_like(p)))


def gram_matrix(features: torch.Tensor, normalize: bool = True
                ) -> torch.Tensor:
    """Gram matrix of a (H, W, C) feature map (misc_py/img_stats.py)."""
    h, w, c = features.shape
    flat = features.reshape(h * w, c)
    g = flat.T @ flat
    return g / (h * w * c) if normalize else g


def gram_histogram(features: torch.Tensor, num_bins: int = 100):
    """Histogram of Gram-matrix entries (misc_py/gram_hist.py): (counts,
    edges)."""
    g = gram_matrix(features).reshape(-1)
    counts, lo, span = _histogram(g, num_bins)
    edges = lo + span * torch.arange(num_bins + 1, device=g.device,
                                     dtype=g.dtype) / num_bins
    return counts, edges

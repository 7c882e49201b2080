"""Profile MLP over the image-statistics compendium (port of
emx/nn/profiles.py).

Rebuild of reference misc_py/profiles.py:1-211 (+ profiles_miner.py,
profile_trainvaltest_split.py): a small MLP over the per-image statistic
vector (emx_torch.physics.image_stats), with feature equalisation by the
empirical-CDF redistributors (emx_torch.analysis.pearson.
moment_redistributor).

Dropout keeps a unit where a uniform draw is below 1 - rate, scaled by
1 / (1 - rate), as flax's nn.Dropout; the keep masks come from the
caller (`dropout_keep`, one per hidden layer) or from `generator`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from emx_torch.nn.blocks import Dense, Named
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ProfileMLPConfig:
    hidden: tuple[int, ...] = (256, 256, 128)
    out_dim: int = 1
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32


class ProfileMLP(Named):
    def __init__(self, config: ProfileMLPConfig = ProfileMLPConfig(),
                 in_features: int = 40,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.config = cfg = config
        self.layers, c = [], in_features
        for f in cfg.hidden:
            self.layers.append(self._add(Dense(c, f, cfg.dtype)))
            c = f
        self.out = self._add(Dense(c, cfg.out_dim, cfg.dtype))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_keep: list[torch.Tensor] | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.config
        h = x.to(cfg.dtype)
        for i, n in enumerate(self.layers):
            h = torch.relu(self._modules[n](h))
            if cfg.dropout and train:
                keep_prob = 1.0 - cfg.dropout
                keep = (dropout_keep[i] if dropout_keep is not None else
                        torch.rand(h.shape, generator=generator,
                                   device=h.device) < keep_prob)
                h = torch.where(keep, h / keep_prob, torch.zeros_like(h))
        return self._modules[self.out](h).float()


def stats_to_feature_vector(stats: dict[str, torch.Tensor]) -> torch.Tensor:
    """Flatten an emx_torch.physics.image_stats dict to a fixed-order
    vector (STAT_NAMES order, last axis)."""
    from emx_torch.physics.stats import STAT_NAMES

    return torch.stack([torch.as_tensor(stats[k], dtype=torch.float32)
                        for k in STAT_NAMES], dim=-1)


class FeatureEqualizer:
    """Per-feature empirical-CDF equalisation (profiles_miner.py); numpy."""

    def __init__(self, feature_matrix: np.ndarray, num_bins: int = 100):
        from emx_torch.analysis.pearson import moment_redistributor

        self.redistributors = [
            moment_redistributor(feature_matrix[:, i], num_bins)
            for i in range(feature_matrix.shape[1])]

    def __call__(self, features: np.ndarray) -> np.ndarray:
        features = np.atleast_2d(np.asarray(features, np.float64))
        cols = [r["transform"](features[:, i])
                for i, r in enumerate(self.redistributors)]
        return np.stack(cols, axis=1).astype(np.float32)

"""Fractal recursive convolutions (port of emx/nn/fractal.py).

Capability rebuild of the reference prototype misc_py/recur_conv_start.py
(a DRCN-style sketch): an embedding block, one weight-SHARED recursive
conv applied `turns` times, and a shared reconstruction head applied at
every recursion depth, the outputs averaged over depths. The shared
weights are one child module (`recur`) called in a loop.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from emx_torch.nn.blocks import Conv, SepConvBlock
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FractalConfig:
    features: int = 64
    turns: int = 4
    norm: str = "group"
    dtype: torch.dtype = torch.float32


class RecursiveFractalConv(nn.Module):
    """embedding -> (shared recursive conv)^turns -> shared reconstruction
    head at every depth, outputs averaged over depths."""

    def __init__(self, config: FractalConfig = FractalConfig(),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.config = cfg = config
        f, kw = cfg.features, dict(norm=cfg.norm, dtype=cfg.dtype)
        self.embed1 = SepConvBlock(cin, f, **kw)
        self.embed2 = SepConvBlock(f, f, **kw)
        self.recur = SepConvBlock(f, f, **kw)    # ONE set of weights
        self.recon1 = SepConvBlock(cin + f, f, **kw)
        self.recon2 = SepConvBlock(f, f, **kw)
        self.head = Conv(f, 1, 3, dtype=cfg.dtype)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg = self.config
        squeeze = x.dim() == 3
        if squeeze:
            x = x[..., None]
        x = x.to(cfg.dtype)
        state = self.embed2(self.embed1(x, train), train)
        out_sum = torch.zeros_like(x[..., :1])
        for _ in range(cfg.turns):
            state = self.recur(state, train)
            cat = torch.cat([x, state], dim=-1)
            r = self.recon2(self.recon1(cat, train), train)
            out_sum = out_sum + self.head(r)
        out = (out_sum / cfg.turns).float()
        return out[..., 0] if squeeze else out

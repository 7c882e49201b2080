"""Flagship low-dose micrograph denoiser (port of emx/nn/denoiser.py).

Space-to-depth, a DeepLabv3+ separable encoder, Xception middle
blocks, a separable ASPP, two decoder stages, a body-resolution
refinement, an optional folded-space head, and a clip to [0, 1].
Children are created in the order flax calls them and carry flax's
names, so each module's `path` is its flax parameter path.

Only the plain and folded heads are ported; `full_res_head`,
`mid_res_head` and `kernel_pred_head` raise NotImplementedError.
`forward(x, train=True)` trains (BatchNorm on batch statistics), with
the middle blocks rematerialised under `remat_middle`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from emx_torch.nn.blocks import (ASPP, BatchNorm, ConvBlock, DeconvBlock,
                                 SepConvBlock, XceptionMiddleBlock,
                                 _resize_bilinear)
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    features: tuple[int, ...] = (64, 128, 256, 728, 728)
    num_middle_blocks: int = 11
    aspp_filters: int = 728
    aspp_out: int = 256
    aspp_rates: tuple[int, ...] = (6, 12, 18)
    norm: str = "group"
    axis_name: str | None = None
    aspp_separable: bool = True
    upsample: str = "transpose"
    space_to_depth: int = 2
    dtype: torch.dtype = torch.float32
    remat_middle: bool = False
    full_res_head: int = 0
    mid_res_head: int = 0
    mid_res_factor: int = 2
    mid_res_depth: int = 2
    kernel_pred_head: int = 0
    kernel_pred_sigmas: tuple[float, ...] = (1.0, 2.0, 4.0)
    folded_head: int = 0
    folded_head_depth: int = 2
    out_dtype: str = "float32"

    @classmethod
    def tiny(cls) -> "DenoiserConfig":
        return cls(features=(8, 12, 16, 24, 24), num_middle_blocks=1,
                   aspp_filters=16, aspp_out=16)


def _space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """Fold f x f spatial blocks into channels (NHWC)."""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh // f, f, ww // f, f, c)
    return torch.movedim(x, 2, 4).reshape(b, hh // f, ww // f, f * f * c)


def _depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Unfold channels into f x f spatial blocks (NHWC)."""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh, ww, f, f, c // (f * f))
    return torch.movedim(x, 3, 2).reshape(b, hh * f, ww * f, c // (f * f))


_OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Denoiser(nn.Module):
    def __init__(self, config: DenoiserConfig = DenoiserConfig(),
                 device: str | torch.device = "cuda"):
        """Parameters start at zero: emx_torch.serve.convert fills them
        from a bundle, emx_torch.nn.init.init_parameters from a seed."""
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        for head in ("full_res_head", "mid_res_head", "kernel_pred_head"):
            if getattr(cfg, head):
                raise NotImplementedError(
                    f"{head} is not ported yet (ROADMAP.md Queue 1)")
        self._counts: dict[str, int] = {}
        kw = dict(norm=cfg.norm, dtype=cfg.dtype)
        f = cfg.features
        s2d = cfg.space_to_depth
        c = s2d * s2d
        self._encoder = []
        taps = []
        for i in range(4):
            run, emit = f[i], (f[1] if i == 0 else f[i])
            self._encoder.append((
                self._add(SepConvBlock(c, run, **kw)),
                self._add(SepConvBlock(run, run, **kw)),
                self._add(SepConvBlock(run, emit, strides=2, **kw)),
                self._add(ConvBlock(c, emit, kernel=1, strides=2, **kw)),
            ))
            c = emit
            taps.append(c)
        self._block4 = [self._add(SepConvBlock(c, f[4], **kw)),
                        self._add(SepConvBlock(f[4], f[4], **kw)),
                        self._add(SepConvBlock(f[4], f[4], **kw))]
        self._middle = []
        for i in range(cfg.num_middle_blocks):
            name = f"XceptionMiddleBlock_{i}"
            self.add_module(name, XceptionMiddleBlock(f[4], **kw))
            self._middle.append(name)
        self._aspp = self._add(ASPP(f[4], cfg.aspp_filters, cfg.aspp_out,
                                    cfg.aspp_rates,
                                    separable=cfg.aspp_separable, **kw))
        c = cfg.aspp_out
        self._decoder = []
        for width, tap in ((f[2], taps[1]), (f[1], taps[0])):
            cin = c + tap
            self._decoder.append((
                self._add(SepConvBlock(cin, width, **kw)),
                self._add(SepConvBlock(width, width, **kw)),
                self._add(ConvBlock(cin, width, kernel=1, **kw)),
                self._add(DeconvBlock(width, width, norm=cfg.norm,
                                      mode=cfg.upsample, dtype=cfg.dtype)),
            ))
            c = width
        self._refine = (self._add(SepConvBlock(c, f[0], **kw)),
                        self._add(SepConvBlock(f[0], f[0], **kw)),
                        self._add(ConvBlock(c, f[0], kernel=1, **kw)))
        c = f[0]
        self._folded = None
        if cfg.folded_head and s2d > 1:
            cin = c + s2d * s2d
            seps, r = [], cin
            for _ in range(cfg.folded_head_depth):
                seps.append(self._add(SepConvBlock(r, cfg.folded_head, **kw)))
                r = cfg.folded_head
            skip = self._add(ConvBlock(cin, cfg.folded_head, kernel=1, **kw))
            self._folded = (seps, skip)
            c = cfg.folded_head
        self._head = self._add(ConvBlock(c, s2d * s2d, kernel=3, **kw))
        for name, mod in self.named_modules():
            if hasattr(mod, "path"):
                mod.path = name.replace(".", "/")
        self.to(device)

    def _add(self, mod: nn.Module) -> str:
        """Register `mod` under flax's name for it: class name and the
        count of earlier children of that class."""
        cls = type(mod).__name__
        i = self._counts.get(cls, 0)
        self._counts[cls] = i + 1
        name = f"{cls}_{i}"
        self.add_module(name, mod)
        return name

    def _middle_block(self, name: str, h: torch.Tensor,
                      train: bool) -> torch.Tensor:
        """One Xception middle block; with `remat_middle` in training its
        activations are recomputed in the backward pass (flax nn.remat).
        The recomputation runs with the block's BatchNorm updates off, so
        the running statistics move once per step, as under flax."""
        block = self._modules[name]
        if not (self.config.remat_middle and train
                and torch.is_grad_enabled()):
            return block(h, train)
        return checkpoint(block, h, train, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _frozen_stats(block)))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W) or (B, H, W, 1) input -> prediction of that shape,
        clipped to [0, 1] in `out_dtype`. `train` normalises BatchNorm by
        the batch's statistics and updates the running ones, as flax's
        `train=True` with `mutable=["batch_stats"]` does."""
        cfg = self.config
        m = self._modules
        squeeze = x.dim() == 3
        if squeeze:
            x = x[..., None]
        x = x.to(cfg.dtype)
        x_in = x
        s2d = cfg.space_to_depth
        if s2d > 1:
            x = _space_to_depth(x, s2d)

        taps = []
        h = x
        for sep_a, sep_b, down, res in self._encoder:
            a = m[sep_b](m[sep_a](h, train), train)
            h = m[down](a, train) + m[res](h, train)
            taps.append(h)
        a = h
        for name in self._block4:
            a = m[name](a, train)
        h = a + h
        for name in self._middle:
            h = self._middle_block(name, h, train)
        h = m[self._aspp](h, train)

        h = _resize_bilinear(h, (h.shape[1] * 4, h.shape[2] * 4))
        h = h.to(cfg.dtype)
        for (sep_a, sep_b, skip, deconv), tap in zip(self._decoder,
                                                     (taps[1], taps[0])):
            cat = torch.cat([h, tap], dim=-1)
            d = m[sep_b](m[sep_a](cat, train), train)
            d = d + m[skip](cat, train)
            h = m[deconv](d, train)

        sep_a, sep_b, skip = self._refine
        d = m[sep_b](m[sep_a](h, train), train) + m[skip](h, train)
        if self._folded is not None:
            seps, skip = self._folded
            cat = torch.cat([d, _space_to_depth(x_in, s2d)], dim=-1)
            r = cat
            for name in seps:
                r = m[name](r, train)
            d = r + m[skip](cat, train)
        out = m[self._head](d, train)
        if s2d > 1:
            out = _depth_to_space(out, s2d)
        out = torch.clamp(out.to(_OUT_DTYPES[cfg.out_dtype]), 0.0, 1.0)
        return out[..., 0] if squeeze else out


@contextlib.contextmanager
def _frozen_stats(module: nn.Module):
    """BatchNorm running-statistic updates off inside `module`."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in norms:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in norms:
            bn.update_stats = True

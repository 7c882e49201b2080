"""Partial-scan infilling GAN (port of emx/nn/infilling.py).

Generator (reference misc_py/gan-infilling-100.py generator_architecture:
250-374): 7x7 separable stem -> stride-2 encoder -> residual
network-in-network global path (3 stride-2 downs to 1/16 resolution,
Xception middle blocks, 3 resize-conv ups) -> local Xception enhancer
blocks -> resize-conv up to full resolution -> separable block -> 3x3
conv -> instance norm -> tanh.

Discriminator (discriminator_architecture:376-708): three heads (small,
medium, large) over multiscale random crops, each stride-2 separable
convs -> global average pool -> dense logit; prob = sigmoid(max logit),
and every intermediate activation for the feature-matching loss.

Children carry flax's names (`Conv_0`, `Norm_1`, `SepConvBlock_2`,
`small/Dense_0`, ...), so emx_torch.serve.convert moves parameters
across. Activations are NHWC, parameters float32 and cast to the
config's dtype at each conv, as in emx_torch.nn.blocks.

`multiscale_crops` takes its crop offsets from the caller (`crop_offsets`
draws them), so a step's draws can come from anywhere, emx's included.
Its large crop is shrunk by 3 with jax.image.resize's antialiased
triangle filter, as interpolation matrices (`resize_matrix`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emx_torch.nn.blocks import (Conv, Dense, Norm, SepConvBlock,
                                 XceptionMiddleBlock, _avg_pool_2x2_same,
                                 _resize_bilinear, relu6)
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class InfillingConfig:
    gen_features: tuple[int, int, int, int] = (32, 64, 64, 32)
    nin_down: tuple[int, int, int] = (128, 256, 768)
    nin_up: tuple[int, int, int] = (256, 128, 64)
    num_global_blocks: int = 8
    num_local_blocks: int = 3
    disc_features: tuple[int, ...] = (32, 64, 128, 256, 512)
    norm: str = "group"  # reference uses batch norm; group is batch-size-proof
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls) -> "InfillingConfig":
        return cls(gen_features=(8, 8, 8, 8), nin_down=(8, 8, 16),
                   nin_up=(8, 8, 8), num_global_blocks=1, num_local_blocks=1,
                   disc_features=(8, 8, 16))

    def scaled(self, scale: float) -> "InfillingConfig":
        """emx.bench.gan_quality's widths at `scale` (1.0 = reference)."""
        def s(v):
            return max(8, int(v * scale))

        return dataclasses.replace(
            self, gen_features=tuple(s(v) for v in (32, 64, 64, 32)),
            nin_down=tuple(s(v) for v in (128, 256, 768)),
            nin_up=tuple(s(v) for v in (256, 128, 64)),
            num_global_blocks=max(2, int(8 * scale)),
            num_local_blocks=max(2, int(3 * scale)),
            disc_features=tuple(s(v) for v in (32, 64, 128, 256, 512)))


class _Named(nn.Module):
    """Children registered under flax's auto names: the class name and the
    count of earlier children of that class."""

    def __init__(self):
        super().__init__()
        self._counts: dict[str, int] = {}

    def _add(self, mod: nn.Module) -> str:
        cls = type(mod).__name__
        i = self._counts.get(cls, 0)
        self._counts[cls] = i + 1
        name = f"{cls}_{i}"
        self.add_module(name, mod)
        return name


class InfillingGenerator(_Named):
    def __init__(self, config: InfillingConfig = InfillingConfig(),
                 device: str | torch.device = "cuda", cin: int = 1):
        """Parameters start at zero: emx_torch.serve.convert fills them
        from a state, emx_torch.nn.init.init_parameters from a seed."""
        super().__init__()
        self.config = cfg = config
        kw = dict(norm=cfg.norm, dtype=cfg.dtype)
        g0, g1, g2, g3 = cfg.gen_features
        self.stem = (self._add(Conv(cin, cin, 7, groups=cin,
                                    dtype=cfg.dtype)),
                     self._add(Conv(cin, g0, 1, dtype=cfg.dtype)),
                     self._add(Norm(cfg.norm, g0, cfg.dtype)))
        self.enc = self._add(SepConvBlock(g0, g1, strides=2, **kw))
        self.down, c = [], g1
        for f in cfg.nin_down:
            self.down.append(self._add(SepConvBlock(c, f, strides=2, **kw)))
            c = f
        self.glob = [self._add(XceptionMiddleBlock(c, **kw))
                     for _ in range(cfg.num_global_blocks)]
        self.up = []
        for f in cfg.nin_up:
            self.up.append(self._resize_conv(c, f))
            c = f
        self.proj = (self._add(Conv(c, g1, 1, dtype=cfg.dtype))
                     if c != g1 else None)
        if cfg.num_local_blocks and g1 != g2:
            raise ValueError("the local blocks are residual: gen_features "
                             f"[1] and [2] must agree, got {g1} and {g2}")
        self.local = [self._add(XceptionMiddleBlock(g2, **kw))
                      for _ in range(cfg.num_local_blocks)]
        self.full = self._resize_conv(g2 if cfg.num_local_blocks else g1, g3)
        self.tail = self._add(SepConvBlock(g3, g3, **kw))
        self.head = (self._add(Conv(g3, 1, 3, dtype=cfg.dtype)),
                     self._add(Norm("instance", 1, cfg.dtype)))
        self.to(resolve_device(device))

    def _resize_conv(self, cin: int, features: int) -> tuple[str, str]:
        """Resize-conv upsample (emx's _resize_conv): bilinear 2x, 3x3
        conv, norm, relu6."""
        cfg = self.config
        return (self._add(Conv(cin, features, 3, dtype=cfg.dtype)),
                self._add(Norm(cfg.norm, features, cfg.dtype)))

    def _run_resize_conv(self, names, x, train):
        conv, norm = (self._modules[n] for n in names)
        h, w = x.shape[1], x.shape[2]
        x = _resize_bilinear(x, (2 * h, 2 * w)).to(self.config.dtype)
        return relu6(norm(conv(x), train))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W) or (B, H, W, C) in [-1, 1] -> the same shape, in
        [-1, 1], float32."""
        cfg, m = self.config, self._modules
        squeeze = x.dim() == 3
        if squeeze:
            x = x[..., None]
        x = x.to(cfg.dtype)
        dw, pw, norm = (m[n] for n in self.stem)
        h = relu6(norm(pw(dw(x)), train))
        enc = m[self.enc](h, train)
        nin = enc
        for n in self.down + self.glob:
            nin = m[n](nin, train)
        for names in self.up:
            nin = self._run_resize_conv(names, nin, train)
        if self.proj is not None:
            nin = m[self.proj](nin)
        enc = enc + nin
        for n in self.local:
            enc = m[n](enc, train)
        enc = self._run_resize_conv(self.full, enc, train)
        enc = m[self.tail](enc, train)
        conv, norm = (m[n] for n in self.head)
        out = torch.tanh(norm(conv(enc)).float())
        return out[..., 0] if squeeze else out


class _DiscriminatorHead(_Named):
    """emx's _DiscriminatorHead: [2x2 average pool], stride-2 separable
    blocks, global average pool, dense logit (float32)."""

    def __init__(self, features: tuple[int, ...], norm: str,
                 dtype: torch.dtype, prepool: bool = False, cin: int = 1):
        super().__init__()
        self.prepool = prepool
        self.blocks, c = [], cin
        for f in features:
            self.blocks.append(self._add(SepConvBlock(c, f, strides=2,
                                                      norm=norm,
                                                      dtype=dtype)))
            c = f
        self.Dense_0 = Dense(c, 1, dtype)

    def forward(self, x: torch.Tensor, train: bool = False):
        taps = []
        if self.prepool:
            x = _avg_pool_2x2_same(x)
        for n in self.blocks:
            x = self._modules[n](x, train)
            taps.append(x)
        logit = self.Dense_0(torch.mean(x, dim=(1, 2)))
        return logit[..., 0].float(), taps


class MultiscaleDiscriminator(nn.Module):
    """Heads over the (small, medium, large) crops. Returns (prob,
    features): prob = sigmoid(max of the head logits), the reference's
    sigmoid-of-max readout (gan-infilling-100.py:698-708), and features
    every head's intermediate activations."""

    def __init__(self, config: InfillingConfig = InfillingConfig(),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.config = cfg = config
        args = (cfg.disc_features, cfg.norm, cfg.dtype)
        self.small = _DiscriminatorHead(*args, cin=cin)
        self.medium = _DiscriminatorHead(*args, prepool=True, cin=cin)
        self.large = _DiscriminatorHead(*args, cin=cin)
        self.to(resolve_device(device))

    def forward(self, crops, train: bool = False):
        def to4d(t):
            return t[..., None] if t.dim() == 3 else t

        outs = [head(to4d(c), train) for head, c in
                zip((self.small, self.medium, self.large), crops)]
        logits = torch.stack([o[0] for o in outs], dim=-1)
        prob = torch.sigmoid(torch.amax(logits, dim=-1))
        return prob, [t for o in outs for t in o[1]]


@functools.lru_cache(maxsize=32)
def _resize_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of jax.image.resize(..., "linear") along one
    axis, antialiased as jax does by default (compute_weight_mat: the
    triangle kernel widened by n_in / n_out when shrinking, columns
    normalised to sum 1)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T.copy()


def resize_matrix(n_in: int, n_out: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix_np(n_in, n_out)).to(device, dtype)


def resize_linear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, (b, *size, c), "linear") of an NHWC tensor,
    antialiased when shrinking: two products with the axes' matrices."""
    ah = resize_matrix(x.shape[1], size[0], x.dtype, x.device)
    aw = resize_matrix(x.shape[2], size[1], x.dtype, x.device)
    y = torch.einsum("oh,bhwc->bowc", ah, x)
    return torch.einsum("pw,bowc->bopc", aw, y)


def crop_offsets(generator: torch.Generator, h: int,
                 cropsize: int | None = None) -> tuple:
    """The (y, x) offsets of the three multiscale crops of an h x h batch,
    drawn from `generator` (host integers: slicing needs them there)."""
    n = cropsize or h
    padded = h + 2 * ((3 * n) // 4)
    out = []
    for size in (n // 4, n // 2, (3 * n) // 4):
        hi = padded - size + 1
        yx = torch.randint(0, hi, (2,), generator=generator)
        out.append((int(yx[0]), int(yx[1])))
    return tuple(out)


def multiscale_crops(offsets, img: torch.Tensor,
                     cropsize: int | None = None):
    """Multiscale crops for the discriminator (reference
    get_multiscale_crops, gan-infilling-100.py:957-980): reflect-pad by
    3/4 of the crop size, crop at 1/4, 1/2 and 3/4 of it at `offsets`
    (crop_offsets), and shrink the large crop to 1/4. NHWC out."""
    if img.dim() == 3:
        img = img[..., None]
    h = img.shape[1]
    n = cropsize or h
    pad = (3 * n) // 4
    padded = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="reflect").permute(0, 2, 3, 1)
    crops = [padded[:, y:y + size, x:x + size]
             for (y, x), size in zip(offsets, (n // 4, n // 2, (3 * n) // 4))]
    crops[2] = resize_linear(crops[2], (n // 4, n // 4))
    return tuple(crops)

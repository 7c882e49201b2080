"""Building blocks of the denoiser (port of emx/nn/blocks.py).

Every module here is the twin of a flax module of the same class name,
and its children carry the names flax gives them (`Conv_0`, `Norm_0`,
`SepConvBlock_1`, ...), so a module's dotted name in `named_modules()`
is its flax parameter path with "/" for ".". Activations are NHWC;
each conv permutes to a channels-last NCHW view around the
`torch.nn.functional` call, which costs no copy. Weights are OIHW.
Parameters stay float32 and are cast to the module's dtype per call,
as flax's `dtype=` does.

Padding follows XLA's SAME rule: a stride-2 3x3 conv on an even size
pads (0, 1), a dilated 3x3 conv pads `rate` on each side.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


class Named(nn.Module):
    """A module whose children are registered under flax's auto names:
    the class name and the count of earlier children of that class."""

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


def same_pads(size: int, kernel: int, stride: int,
              dilation: int = 1) -> tuple[int, int]:
    """XLA's SAME padding (low, high) for one spatial axis."""
    out = -(-size // stride)
    span = (kernel - 1) * dilation + 1
    total = max((out - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int = 1,
             dilation: int = 1) -> torch.Tensor:
    """Zero-pad an NHWC tensor by the SAME rule, so a conv with padding
    0 gives XLA's SAME result."""
    top, bottom = same_pads(x.shape[1], kernel, stride, dilation)
    left, right = same_pads(x.shape[2], kernel, stride, dilation)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (0, 0, left, right, top, bottom))


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
              dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """SAME conv of an NHWC tensor with an OIHW weight; NHWC out."""
    k = weight.shape[-1]
    if k == 1 and stride > 1:
        # A strided 1x1 conv reads every stride-th pixel; slicing first is
        # the same conv, and it avoids a crash of the multi-threaded
        # oneDNN backward of a strided channels-last 1x1 conv on the CPU.
        x, stride = x[:, ::stride, ::stride, :], 1
    x = pad_same(x, k, stride, dilation)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, 0,
                 dilation, groups)
    return y.permute(0, 2, 3, 1).contiguous()


class Conv(nn.Module):
    """Twin of flax `nn.Conv(padding="SAME")`. The bias is added after
    the conv, in the compute dtype, as flax does."""

    def __init__(self, cin: int, features: int, kernel: int = 1,
                 strides: int = 1, rate: int = 1, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(features, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.kernel, self.strides, self.rate = kernel, strides, rate
        self.groups, self.dtype = groups, dtype
        self.path = ""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(x.to(self.dtype), self.weight.to(self.dtype),
                      self.strides, self.rate, self.groups)
        return y + self.bias.to(self.dtype)


class Dense(nn.Module):
    """Twin of flax `nn.Dense`: `kernel` (in, out) as flax stores it, the
    product and the bias in the module's dtype; dtype None promotes the
    input's with the parameters', as flax's `dtype=None` does."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype | None = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class ConvTranspose(nn.Module):
    """Twin of flax `nn.ConvTranspose((3, 3), strides=(2, 2), "SAME")`.
    The weight holds the flax kernel flipped in space, as (I, O, 3, 3):
    torch's transposed conv with padding 0, cropped to (2H, 2W), then
    equals flax's."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.path = ""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype), None, 2)
        y = y[:, :, :2 * h, :2 * w].permute(0, 2, 3, 1).contiguous()
        return y + self.bias.to(self.dtype)


class GroupNorm(nn.Module):
    """Twin of flax `nn.GroupNorm` (eps 1e-6): statistics in at least
    float32, output in the module's dtype."""

    def __init__(self, channels: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.dtype = groups, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] * x.shape[2] * (x.shape[3] // self.groups) == 1:
            # One value per group: x - mean is 0, so flax returns the
            # bias, where F.group_norm refuses a batch of one.
            y = self.bias.float().expand(x.shape)
            return y.to(self.dtype).contiguous()
        dt = torch.promote_types(x.dtype, torch.float32)
        y = F.group_norm(x.to(dt).permute(0, 3, 1, 2), self.groups,
                         self.weight.to(dt), self.bias.to(dt), eps=1e-6)
        return y.permute(0, 2, 3, 1).to(self.dtype).contiguous()


class BatchNorm(nn.Module):
    """Twin of flax `nn.BatchNorm(momentum=0.99, epsilon=1e-3)`.

    At inference the running mean and variance normalise. In training
    the batch's statistics over N, H and W do, in float32, with flax's
    one-pass biased variance max(E[x^2] - E[x]^2, 0); the running
    statistics then move to 0.99 * running + 0.01 * batch (not
    `F.batch_norm`'s update, which stores the unbiased variance).
    `update_stats` False skips that move: a rematerialised block's
    second forward must not take it again."""

    MOMENTUM = 0.99
    EPS = 1e-3

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.dtype = dtype
        self.update_stats = True

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        # Statistics in at least float32, as flax's force_float32_reductions.
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            dims = tuple(range(xf.dim() - 1))
            mean = xf.mean(dims)
            var = torch.clamp(xf.square().mean(dims) - mean.square(), min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    self.mean.mul_(self.MOMENTUM).add_(
                        (1.0 - self.MOMENTUM) * mean.detach())
                    self.var.mul_(self.MOMENTUM).add_(
                        (1.0 - self.MOMENTUM) * var.detach())
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.EPS) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype)


class Norm(nn.Module):
    """Twin of emx.nn.blocks.Norm: 'none', 'group', 'instance' or
    'batch'."""

    def __init__(self, kind: str, channels: int, dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        if kind == "group":
            groups = min(32, channels)
            while channels % groups:
                groups -= 1
            self.GroupNorm_0 = GroupNorm(channels, groups, dtype)
        elif kind == "batch":
            self.BatchNorm_0 = BatchNorm(channels, dtype)
        elif kind == "instance":
            # flax GroupNorm(num_groups=None, group_size=1): one group
            # per channel, under the same child name.
            self.GroupNorm_0 = GroupNorm(channels, channels, dtype)
        elif kind != "none":
            raise ValueError(f"unknown norm kind {kind!r}")

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.kind in ("group", "instance"):
            return self.GroupNorm_0(x)
        if self.kind == "batch":
            return self.BatchNorm_0(x, train)
        return x


class ConvBlock(nn.Module):
    """Conv -> norm -> relu6."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 strides: int = 1, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, strides, dtype=dtype)
        self.Norm_0 = Norm(norm, features, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return relu6(self.Norm_0(self.Conv_0(x), train))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2
               ) -> torch.Tensor:
    """flax nn.leaky_relu(x, 0.2), the zoo's activation."""
    return F.leaky_relu(x, negative_slope)


class SepConvBlock(nn.Module):
    """Depthwise 3x3 (stride, dilation) -> pointwise 1x1 -> norm ->
    activation (relu6 unless given: the latent and style families pass
    `leaky_relu`). Only a relu6 block with norm 'none' can run on K1
    (emx_torch/serve/fused.py checks both)."""

    def __init__(self, cin: int, features: int, strides: int = 1,
                 rate: int = 1, norm: str = "batch",
                 dtype: torch.dtype = torch.float32,
                 activation: Callable[[torch.Tensor], torch.Tensor] = relu6):
        super().__init__()
        self.Conv_0 = Conv(cin, cin, 3, strides, rate, groups=cin,
                           dtype=dtype)
        self.Conv_1 = Conv(cin, features, 1, dtype=dtype)
        self.Norm_0 = Norm(norm, features, dtype)
        self.strides, self.rate, self.norm = strides, rate, norm
        self.activation = activation

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.activation(self.Norm_0(self.Conv_1(self.Conv_0(x)), train))


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """(n_out, n_in): F.interpolate's bilinear weights along one axis
    (align_corners False: source (o + 0.5) * n_in / n_out - 0.5, clamped
    at 0; the upper neighbour clamped at n_in - 1)."""
    a = np.zeros((n_out, n_in))
    for o in range(n_out):
        src = max((o + 0.5) * (n_in / n_out) - 0.5, 0.0)
        i0 = min(int(src), n_in - 1)
        lam = src - i0
        a[o, i0] += 1.0 - lam
        a[o, min(i0 + 1, n_in - 1)] += lam
    return torch.from_numpy(a).to(device=device, dtype=dtype)


class _Bilinear(torch.autograd.Function):
    """F.interpolate(mode="bilinear", align_corners=False) on NCHW, whose
    backward is two products with the interpolation matrices, in at
    least float32: deterministic, where F.interpolate's CUDA backward
    adds with atomics in a run-dependent order."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size: tuple[int, int]):
        ctx.in_size = tuple(x.shape[-2:])
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dt = torch.promote_types(g.dtype, torch.float32)
        (h, w), (hh, ww) = ctx.in_size, g.shape[-2:]
        ah = _interp_matrix(h, hh, dt, g.device)
        aw = _interp_matrix(w, ww, dt, g.device)
        t = torch.matmul(ah.t(), g.to(dt))           # (B, C, h, W)
        return torch.matmul(t, aw).to(g.dtype), None  # (B, C, h, w)


def _resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(..., "linear") for upsampling, on NHWC."""
    y = _Bilinear.apply(x.permute(0, 3, 1, 2), tuple(size))
    return y.permute(0, 2, 3, 1).contiguous()


class DeconvBlock(nn.Module):
    """2x upsample -> norm -> relu6: a transposed conv ('transpose') or
    bilinear resize + separable conv ('resize_sep')."""

    def __init__(self, cin: int, features: int, norm: str = "batch",
                 mode: str = "resize_sep",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mode, self.dtype = mode, dtype
        if mode == "transpose":
            self.ConvTranspose_0 = ConvTranspose(cin, features, dtype)
            self.Norm_0 = Norm(norm, features, dtype)
        elif mode == "resize_sep":
            self.SepConvBlock_0 = SepConvBlock(cin, features, norm=norm,
                                               dtype=dtype)
        else:
            raise ValueError(f"unknown upsample mode {mode!r}")

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.mode == "transpose":
            return relu6(self.Norm_0(self.ConvTranspose_0(x), train))
        h, w = x.shape[1], x.shape[2]
        x = _resize_bilinear(x, (2 * h, 2 * w)).to(self.dtype)
        return self.SepConvBlock_0(x, train)


def _avg_pool_2x2_same(x: torch.Tensor) -> torch.Tensor:
    """flax avg_pool((2, 2), strides=(2, 2), padding="SAME") on NHWC:
    padded zeros count in the mean."""
    x = pad_same(x, 2, 2)
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1).contiguous()


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, one dilated 3x3
    branch per rate, a 2x2 average-pooled 1x1 branch resized back,
    concatenated and projected by a 1x1 ConvBlock."""

    def __init__(self, cin: int, filters: int = 728,
                 out_features: int = 256, rates=(6, 12, 18),
                 norm: str = "batch", separable: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(norm=norm, dtype=dtype)
        self.ConvBlock_0 = ConvBlock(cin, filters, kernel=1, **kw)
        self.branches = []
        n_conv = 0
        for i, rate in enumerate(rates):
            if separable:
                name = f"SepConvBlock_{i}"
                self.add_module(name, SepConvBlock(cin, filters, rate=rate,
                                                   **kw))
                self.branches.append((name, None))
                continue
            conv, nrm = f"Conv_{n_conv}", f"Norm_{n_conv}"
            n_conv += 1
            self.add_module(conv, Conv(cin, filters, 3, rate=rate,
                                       dtype=dtype))
            self.add_module(nrm, Norm(norm, filters, dtype))
            self.branches.append((conv, nrm))
        self.pool_conv, self.pool_norm = f"Conv_{n_conv}", f"Norm_{n_conv}"
        self.add_module(self.pool_conv, Conv(cin, filters, 1, dtype=dtype))
        self.add_module(self.pool_norm, Norm(norm, filters, dtype))
        self.ConvBlock_1 = ConvBlock(filters * (len(rates) + 2),
                                     out_features, kernel=1, **kw)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        m = self._modules
        out = [self.ConvBlock_0(x, train)]
        for first, nrm in self.branches:
            if nrm is None:
                out.append(m[first](x, train))
            else:
                out.append(relu6(m[nrm](m[first](x), train)))
        pooled = m[self.pool_conv](_avg_pool_2x2_same(x))
        pooled = _resize_bilinear(pooled, (x.shape[1], x.shape[2]))
        out.append(relu6(m[self.pool_norm](pooled, train)))
        return self.ConvBlock_1(torch.cat(out, dim=-1), train)


class XceptionMiddleBlock(nn.Module):
    """Three separable convs + identity residual."""

    def __init__(self, features: int, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(3):
            self.add_module(f"SepConvBlock_{i}", SepConvBlock(
                features, features, norm=norm, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        for i in range(3):
            h = self._modules[f"SepConvBlock_{i}"](h, train)
        return h + x

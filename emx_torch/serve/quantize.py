"""Post-training int8 serving graphs (port of emx/serve/quantize.py).

  * `calibrate(model, batches)` records, per conv, the per-input-channel
    absolute maximum (or a high `quantile`) of its input over a
    calibration set.
  * `quantized_apply(model, amax, mode)` returns an apply function in
    which every calibrated conv runs quantized:
      mode='store': an int8 round-trip on the conv's input
        (x -> q8 -> dequantized), compute in the model dtype;
      mode='mxu': dense convs run s8 x s8 -> s32. The per-input-channel
        activation scale is folded into the weight before per-output-
        channel weight quantization, so the integer product needs only a
        per-output rescale and the bias after it. Depthwise convs get the
        'store' treatment. Transposed convs are not calibrated and stay
        in the model dtype;
      mode='mxu2': 'mxu', and true depthwise convs run int8 too: int8
        input x int8 per-group kernel, rescaled per output channel.
    `capture` returns the float input of named convs beside the output.
  * `fake_quant_apply(model, amax, mode)` is the differentiable twin of
    `quantized_apply` for quantization-aware finetuning: every
    calibrated conv sees its input on the int8 grid and, in 'mxu' (and
    'mxu2' for true depthwise convs), its weight on the deployment grid,
    with straight-through gradients.

Quantized weights and scales are computed once, when the apply function
is built. The quantized graph is a copy of the model's module tree with
the convs swapped; it shares the model's parameters.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emx_torch.nn.blocks import Conv, conv_nhwc, pad_same


def _quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """jnp.quantile(flat, q, axis=0), linear: the two order statistics
    around q * (n - 1), weighted as jax weighs them, in float32.
    (torch.quantile refuses inputs of more than 2^24 elements.)"""
    n = flat.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    lo, hi = int(torch.floor(pos)), int(torch.ceil(pos))
    w_hi = (pos - lo).to(flat.device)
    s = torch.sort(flat, dim=0).values
    return s[lo] * (1.0 - w_hi) + s[hi] * w_hi


def calibrate(model: nn.Module, batches: Iterable,
              per_channel: bool = True, quantile: float | None = None,
              return_order: bool = False):
    """Run `batches` through `model`, recording per-conv input ranges.

    Returns {conv_path: np.ndarray (C_in,)} when `per_channel`, else
    {conv_path: float}. `quantile` (e.g. 0.9995) takes that quantile of
    |x| per batch instead of the maximum: rare outliers saturate, the
    grid gets finer. `return_order` also returns the conv paths in the
    order the forward first runs them (tail_param_names reads it)."""
    records: dict[str, np.ndarray] = {}
    order: list[str] = []

    def hook(mod, args):
        ax = args[0].detach().float().abs()
        flat = ax.reshape(-1, ax.shape[-1] if per_channel else 1)
        r = (flat.amax(dim=0) if quantile is None
             else _quantile(flat, quantile)).cpu().numpy()
        r = r if per_channel else r[0]
        if mod.path not in records:
            order.append(mod.path)
        records[mod.path] = (np.maximum(records[mod.path], r)
                             if mod.path in records else r)

    handles = [m.register_forward_pre_hook(hook)
               for m in model.modules() if isinstance(m, Conv)]
    try:
        with torch.inference_mode():
            for b in batches:
                model(b)
    finally:
        for h in handles:
            h.remove()
    amax = {k: (v if np.ndim(v) else float(v)) for k, v in records.items()}
    return (amax, order) if return_order else amax


def _scale_of(a) -> torch.Tensor:
    """amax entry (float | list | ndarray) -> float32 scale(s), >0-guarded."""
    s = torch.from_numpy(np.asarray(np.asarray(a, dtype=np.float32) / 127.0,
                                    dtype=np.float32))
    return torch.clamp(s, min=1e-12)


def _weight_scale(w_amax: torch.Tensor) -> torch.Tensor:
    """amax / 127, >0-guarded. The divisor is a tensor: CUDA divides by a
    host scalar through its reciprocal, which rounds otherwise than the
    CPU (and emx) do, and moves weights across int8 levels."""
    return torch.clamp(w_amax / torch.full_like(w_amax, 127.0), min=1e-12)


def _quantize(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / x_scale), -127, 127).to(
        torch.int8)


class StoreConv(nn.Module):
    """int8 round-trip on the input, then the float conv."""

    def __init__(self, conv: Conv, x_scale: torch.Tensor):
        super().__init__()
        self.conv = conv
        self.register_buffer("x_scale", x_scale.to(conv.weight.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = _quantize(x, self.x_scale)
        return self.conv(xq.to(x.dtype) * self.x_scale.to(x.dtype))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Int8Conv(nn.Module):
    """s8 x s8 -> s32 conv through `torch._int_mm`.

    A 1x1 conv is (B*H*W, C) @ (C, Co) (stride 2 takes x[:, ::2, ::2]);
    a kxk conv first gathers its k*k int8 taps into (B*H*W, k*k*C). K
    and N are zero-padded to multiples of 8 and M to more than 16, as
    the CUDA int8 product requires; the padding is exact."""

    def __init__(self, conv: Conv, x_scale: torch.Tensor):
        super().__init__()
        if conv.groups != 1:
            raise ValueError("Int8Conv takes dense convs only")
        self.kernel, self.strides, self.rate = (conv.kernel, conv.strides,
                                                conv.rate)
        dev = conv.weight.device
        x_scale = x_scale.to(dev)
        kf = conv.weight.detach().float() * x_scale.reshape(1, -1, 1, 1)
        w_amax = kf.abs().amax(dim=(1, 2, 3))
        w_scale = _weight_scale(w_amax)
        kq = torch.clamp(torch.round(kf / w_scale.reshape(-1, 1, 1, 1)),
                         -127, 127).to(torch.int8)
        co, cin, k, _ = kq.shape
        self.co, self.k_in = co, k * k * cin
        mat = kq.permute(2, 3, 1, 0).reshape(self.k_in, co)  # (ky, kx, c)
        mat = F.pad(mat, (0, _round_up(co, 8) - co,
                          0, _round_up(self.k_in, 8) - self.k_in))
        self.register_buffer("wq", mat.contiguous())
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", conv.bias.detach().float())
        self.register_buffer("x_scale", x_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = _quantize(x, self.x_scale)
        k, s, d = self.kernel, self.strides, self.rate
        if k == 1:
            taps = xq[:, ::s, ::s] if s > 1 else xq
        else:
            b, h, w, _ = xq.shape
            ho, wo = -(-h // s), -(-w // s)
            xp = pad_same(xq, k, s, d)
            taps = torch.stack(
                [xp[:, ky * d:ky * d + (ho - 1) * s + 1:s,
                    kx * d:kx * d + (wo - 1) * s + 1:s]
                 for ky in range(k) for kx in range(k)], dim=3)
        out_shape = (*taps.shape[:3], self.co)
        a = taps.reshape(-1, self.k_in)
        m = a.shape[0]
        a = F.pad(a, (0, self.wq.shape[0] - self.k_in, 0, max(0, 17 - m)))
        acc = torch._int_mm(a.contiguous(), self.wq)[:m, :self.co]
        out = acc.float() * self.w_scale + self.bias
        return out.reshape(out_shape).to(x.dtype)


class Int8DepthwiseConv(nn.Module):
    """s8 x s8 -> s32 depthwise conv ('mxu2'). The per-input-channel
    activation scale folds along the kernel's output axis, which is only
    right for a true depthwise conv (one group per channel, multiplier 1).

    Route: nine shifted int32 multiply-adds, exact on every device.
    torch._int_mm takes no grouped conv, and a cuDNN float32 conv of the
    integer values is not exact on the card (its algorithm may transform
    the operands, as Winograd does)."""

    def __init__(self, conv: Conv, x_scale: torch.Tensor):
        super().__init__()
        if not is_depthwise(conv):
            raise ValueError("Int8DepthwiseConv takes true depthwise convs")
        self.kernel, self.strides, self.rate = (conv.kernel, conv.strides,
                                                conv.rate)
        dev = conv.weight.device
        x_scale = x_scale.to(dev)
        kf = conv.weight.detach().float() * x_scale.reshape(-1, 1, 1, 1)
        w_scale = _weight_scale(kf.abs().amax(dim=(1, 2, 3)))
        kq = torch.clamp(torch.round(kf / w_scale.reshape(-1, 1, 1, 1)),
                         -127, 127)
        # (ky, kx, C) int32 taps.
        self.register_buffer("wq", kq[:, 0].permute(1, 2, 0).to(
            torch.int32).contiguous())
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", conv.bias.detach().float())
        self.register_buffer("x_scale", x_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, d = self.kernel, self.strides, self.rate
        b, h, w, _ = x.shape
        ho, wo = -(-h // s), -(-w // s)
        xp = pad_same(_quantize(x, self.x_scale), k, s, d).to(torch.int32)
        acc = sum(xp[:, ky * d:ky * d + (ho - 1) * s + 1:s,
                     kx * d:kx * d + (wo - 1) * s + 1:s] * self.wq[ky, kx]
                  for ky in range(k) for kx in range(k))
        return (acc.float() * self.w_scale + self.bias).to(x.dtype)


def is_depthwise(conv: Conv) -> bool:
    """One group per input channel and one output per group."""
    cin = conv.weight.shape[1] * conv.groups
    return (conv.groups > 1 and conv.groups == cin
            and conv.weight.shape[0] == cin)


class Capture(nn.Module):
    """Records its module's input under `path` in `store`, then runs it."""

    def __init__(self, inner: nn.Module, path: str, store: dict):
        super().__init__()
        self.inner, self.path, self.store = inner, path, store

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.store[self.path] = x
        return self.inner(x)


MODES = ("store", "mxu", "mxu2")


def swap_modules(model: nn.Module,
                 replace: Callable[[nn.Module], nn.Module | None]
                 ) -> nn.Module:
    """Copy of `model`'s module tree in which every module for which
    `replace` returns a module is swapped for it. Modules are shallow
    copies: parameters are shared, not duplicated."""
    new = replace(model)
    if new is not None:
        return new
    clone = copy.copy(model)
    clone._modules = {name: swap_modules(child, replace)
                      for name, child in model._modules.items()}
    return clone


def quantize_convs(model: nn.Module, amax: dict[str, Any], mode: str,
                   skip: Iterable[str] = (),
                   capture: dict | None = None) -> nn.Module:
    """`model` with every calibrated conv swapped for its int8 form. The
    convs named in `capture` (a dict, filled on every forward) are
    wrapped to record their float input."""
    if mode not in MODES:
        raise ValueError(f"quantization mode {mode!r} is not one of {MODES}")
    skip = set(skip)

    def quantized(mod: Conv) -> nn.Module:
        p = mod.path
        if p not in amax or p in skip or np.all(np.asarray(amax[p]) <= 0):
            return mod
        x_scale = _scale_of(amax[p])
        if mod.groups == 1 and mode != "store":
            return Int8Conv(mod, x_scale)
        if mode == "mxu2" and is_depthwise(mod):
            return Int8DepthwiseConv(mod, x_scale)
        return StoreConv(mod, x_scale)

    def replace(mod):
        if not isinstance(mod, Conv):
            return None
        if capture is not None and mod.path in capture:
            return Capture(quantized(mod), mod.path, capture)
        return quantized(mod)

    return swap_modules(model, replace)


def quantized_apply(model: nn.Module, amax: dict[str, Any],
                    mode: str = "store", skip: Iterable[str] = (),
                    capture: str | tuple[str, ...] | None = None
                    ) -> Callable[[torch.Tensor], Any]:
    """Build fn(x) running `model` with every calibrated conv quantized.
    `amax` comes from `calibrate`; missing entries and `skip` members
    leave that conv in float.

    `capture`: a conv path, or a tuple of paths; fn(x) then returns
    (output, the float input of that conv), or (output, tuple of inputs
    in the given order), to harvest intermediate features of the
    deployment graph."""
    paths = ((capture,) if isinstance(capture, str)
             else tuple(capture) if capture is not None else ())
    store: dict[str, torch.Tensor] = dict.fromkeys(paths)
    graph = quantize_convs(model, amax, mode, skip,
                           capture=store if paths else None)

    def apply_fn(x: torch.Tensor):
        with torch.inference_mode():
            out = graph(x)
        if isinstance(capture, str):
            return out, store[capture]
        if paths:
            return out, tuple(store[p] for p in paths)
        return out

    return apply_fn


def _ste(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Fake-quantize with a straight-through gradient: the forward is the
    int8 grid round-trip, the backward the identity (round has no
    gradient)."""
    q = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return x + (q - x).detach()


class FakeQuantConv(Conv):
    """A conv on the deployment grid, trainable: it holds the original
    conv's weight and bias Parameters (so parameter names and gradients
    are the model's) and computes, per call,
      'store' (and depthwise convs in 'mxu'): the float conv of the
        fake-quantized input;
      'mxu' (and true depthwise convs in 'mxu2'): the float32 conv of
        the fake-quantized input with the fake-quantized weight, the
        activation scale folded in before per-output-channel weight
        scales taken from the detached weight, then divided out."""

    def __init__(self, conv: Conv, x_scale: torch.Tensor, mode: str):
        nn.Module.__init__(self)
        self.weight, self.bias = conv.weight, conv.bias
        self.kernel, self.strides, self.rate = (conv.kernel, conv.strides,
                                                conv.rate)
        self.groups, self.dtype, self.path = conv.groups, conv.dtype, conv.path
        self.register_buffer("x_scale", x_scale.to(conv.weight.device))
        grouped = conv.groups != 1
        self.int8_weight = mode != "store" and (
            not grouped or (mode == "mxu2" and is_depthwise(conv)))
        # A depthwise kernel (C, 1, 3, 3) reads input channel c in output
        # channel c: the activation scale folds along the output axis.
        self.scale_shape = (-1, 1, 1, 1) if grouped else (1, -1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_fq = _ste(x.float(), self.x_scale)
        if not self.int8_weight:
            return super().forward(x_fq.to(x.dtype))
        s = self.x_scale.reshape(self.scale_shape)
        kf = self.weight.float() * s
        w_scale = _weight_scale(kf.detach().abs().amax(dim=(1, 2, 3),
                                                       keepdim=True))
        k_fq = _ste(kf, w_scale) / s
        out = conv_nhwc(x_fq, k_fq, self.strides, self.rate, self.groups)
        return (out + self.bias.float()).to(x.dtype)


def fake_quant_apply(model: nn.Module, amax: dict[str, Any],
                     mode: str = "mxu", skip: Iterable[str] = ()
                     ) -> Callable:
    """Differentiable twin of `quantized_apply` for quantization-aware
    finetuning: every calibrated conv not in `skip` becomes a
    FakeQuantConv, so gradients steer the float parameters toward
    int8-robust minima. `amax` stays fixed (static calibration: run
    `calibrate` again after finetuning, for serving).

    Returns fn(model_or_params, x, train=False): `model_or_params` is
    `model` itself (the fake-quant graph shares its Parameters, so their
    .grad fills) or a mapping of parameter names (`named_parameters`'
    names) to tensors that stand in for those parameters in this call
    (torch.func.functional_call; the others stay the model's)."""
    if mode not in MODES:
        raise ValueError(f"quantization mode {mode!r} is not one of {MODES}")
    skip = set(skip)

    def replace(mod):
        if not isinstance(mod, Conv):
            return None
        p = mod.path
        if p not in amax or p in skip or np.all(np.asarray(amax[p]) <= 0):
            return mod
        return FakeQuantConv(mod, _scale_of(amax[p]), mode)

    graph = swap_modules(model, replace)

    def apply_fn(model_or_params, x, train: bool = False):
        if model_or_params is model:
            return graph(x, train)
        if isinstance(model_or_params, Mapping):
            return torch.func.functional_call(graph, dict(model_or_params),
                                              (x, train))
        raise TypeError("fake_quant_apply's function takes the model it "
                        "was built from or a mapping of its parameters")

    return apply_fn

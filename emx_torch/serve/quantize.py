"""Post-training int8 serving graphs (port of emx/serve/quantize.py).

  * `calibrate(model, batches)` records, per conv, the per-input-channel
    absolute maximum of its input over a calibration set.
  * `quantized_apply(model, amax, mode)` returns an apply function in
    which every calibrated conv runs quantized:
      mode='store': an int8 round-trip on the conv's input
        (x -> q8 -> dequantized), compute in the model dtype;
      mode='mxu': dense convs run s8 x s8 -> s32. The per-input-channel
        activation scale is folded into the weight before per-output-
        channel weight quantization, so the integer product needs only a
        per-output rescale and the bias after it. Depthwise convs get the
        'store' treatment. Transposed convs are not calibrated and stay
        in the model dtype.

Quantized weights and scales are computed once, when the apply function
is built. The quantized graph is a copy of the model's module tree with
the convs swapped; it shares the model's parameters.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emx_torch.nn.blocks import Conv, pad_same


def calibrate(model: nn.Module, batches: Iterable[torch.Tensor],
              per_channel: bool = True) -> dict[str, Any]:
    """Run `batches` through `model`, recording per-conv input ranges.

    Returns {conv_path: np.ndarray (C_in,)} when `per_channel`, else
    {conv_path: float}."""
    records: dict[str, np.ndarray] = {}

    def hook(mod, args):
        ax = args[0].detach().float().abs()
        flat = ax.reshape(-1, ax.shape[-1] if per_channel else 1)
        r = flat.amax(dim=0).cpu().numpy()
        r = r if per_channel else r[0]
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
    return {k: (v if np.ndim(v) else float(v)) for k, v in records.items()}


def _scale_of(a) -> torch.Tensor:
    """amax entry (float | list | ndarray) -> float32 scale(s), >0-guarded."""
    s = torch.from_numpy(np.asarray(np.asarray(a, dtype=np.float32) / 127.0,
                                    dtype=np.float32))
    return torch.clamp(s, min=1e-12)


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
        w_scale = torch.clamp(w_amax / 127.0, min=1e-12)
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
                   skip: Iterable[str] = ()) -> nn.Module:
    """`model` with every calibrated conv swapped for its int8 form."""
    if mode not in ("store", "mxu"):
        raise NotImplementedError(
            f"quantization mode {mode!r} is not ported yet (ROADMAP.md)")
    skip = set(skip)

    def replace(mod):
        if not isinstance(mod, Conv):
            return None
        p = mod.path
        if p not in amax or p in skip or np.all(np.asarray(amax[p]) <= 0):
            return mod
        x_scale = _scale_of(amax[p])
        if mode == "store" or mod.groups != 1:
            return StoreConv(mod, x_scale)
        return Int8Conv(mod, x_scale)

    return swap_modules(model, replace)


def quantized_apply(model: nn.Module, amax: dict[str, Any],
                    mode: str = "store", skip: Iterable[str] = ()
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build fn(x) running `model` with every calibrated conv quantized.
    `amax` comes from `calibrate`; missing entries and `skip` members
    leave that conv in float."""
    graph = quantize_convs(model, amax, mode, skip)

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return graph(x)

    return apply_fn

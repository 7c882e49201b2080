"""Serving graph with qualifying SepConvBlocks fused (port of
emx/serve/fused.py).

`fused_quantized_apply` builds the int8 graph of `quantized_apply`, but
each SepConvBlock that qualifies (stride 1, rate 1, norm 'none', relu6,
at least `min_pixels` pixels) runs as one `fused_sepconv` kernel in the
activation dtype. A fused block gets no int8 round-trip: the block is
claimed before its convs are quantized, as flax's block-level
interceptor claims it before the conv-level one in `emx`.

`dense_quantized_apply` instead folds each qualifying block's depthwise
-> pointwise pair into one dense 3x3 conv, run int8 (`Int8Conv`) or in
float. Unlike emx's (emx/serve/fused.py:159, which checks only Conv_0),
a block whose Conv_0 or Conv_1 is in `skip` runs its folded conv in
float.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Iterable

import torch
from torch import nn

from emx_torch.nn.blocks import Conv, SepConvBlock, conv_nhwc, relu6
from emx_torch.ops.sepconv_kernel import fused_sepconv
from emx_torch.serve.quantize import (Int8Conv, _scale_of, quantize_convs,
                                      quantized_apply, swap_modules)


def _fusable(mod: nn.Module) -> bool:
    return (isinstance(mod, SepConvBlock)
            and mod.strides == 1 and mod.rate == 1
            and mod.norm == "none" and mod.activation is relu6)


def _qualifies(mod: nn.Module, x: torch.Tensor, min_pixels: int) -> bool:
    return (_fusable(mod) and x.dim() == 4
            and x.shape[1] * x.shape[2] >= min_pixels)


def row_band(h: int, rows: int) -> int:
    """The largest row band <= rows that divides H (emx's rule)."""
    r = min(rows, h)
    while r > 1 and h % r:
        r -= 1
    return r


def load_serve_mode(bundle_path: str) -> dict | None:
    """The `serve_mode.json` sidecar next to a bundle, or None when it
    is missing or records another bundle's content hash."""
    p = os.path.join(os.path.dirname(os.path.abspath(bundle_path)),
                     "serve_mode.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        mode = json.load(f)
    with open(bundle_path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()[:12]
    if mode.get("bundle_sha") != sha:
        return None
    return mode


class FusedSepConv(nn.Module):
    """A SepConvBlock that runs `fused_sepconv` on inputs that qualify
    and its own (quantized) body on the others."""

    def __init__(self, block: SepConvBlock, min_pixels: int, rows: int):
        super().__init__()
        self.block = block
        self.min_pixels, self.rows = min_pixels, rows
        dw, pw = block.Conv_0, block.Conv_1
        # Weights in emx's layouts: dw (3, 3, 1, C), pw (1, 1, C, Co).
        self.register_buffer(
            "dw", dw.weight.detach().float().permute(2, 3, 1, 0).contiguous())
        self.register_buffer("dw_bias", dw.bias.detach().float().contiguous())
        self.register_buffer(
            "pw", pw.weight.detach().float().permute(2, 3, 1, 0).contiguous())
        self.register_buffer("pw_bias", pw.bias.detach().float().contiguous())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise ValueError("the fused serving graph does not train")
        if not _qualifies(self.block, x, self.min_pixels):
            return self.block(x)
        rows = row_band(x.shape[1], self.rows)
        return fused_sepconv(x.contiguous(), self.dw, self.dw_bias, self.pw,
                             self.pw_bias, rows=rows)


def fused_quantized_apply(model: nn.Module, amax: dict[str, Any],
                          mode: str = "mxu", skip: Iterable[str] = (),
                          min_pixels: int = 16384, rows: int = 32
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """`quantized_apply`, with qualifying SepConvBlocks fused.

    Returns fn(x)."""

    def claim(mod):
        return FusedSepConv(mod, min_pixels, rows) if _fusable(mod) else None

    graph = quantize_convs(swap_modules(model, claim), amax, mode, skip)

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return graph(x)

    return apply_fn


class DenseSepConv(nn.Module):
    """A SepConvBlock whose depthwise -> pointwise pair runs as one dense
    3x3 conv on inputs that qualify, and as its own (quantized) body on
    the others. The pair is linear, so

      K[co, ci, ky, kx] = dw[ci, ky, kx] * pw[co, ci]
      b[co]             = pw_b[co] + sum_ci dw_b[ci] * pw[co, ci]

    is exact; relu6 follows. `x_scale` given: the folded conv runs int8
    with the depthwise input's activation scale folded into K, as
    `Int8Conv` treats any dense conv; else it runs in float32 on
    operands rounded to the model dtype, summed in float32 as emx's
    preferred_element_type=float32 conv."""

    def __init__(self, block: SepConvBlock, min_pixels: int,
                 x_scale: torch.Tensor | None):
        super().__init__()
        self.block, self.min_pixels = block, min_pixels
        dw, pw = block.Conv_0, block.Conv_1
        c, co = dw.weight.shape[0], pw.weight.shape[0]
        dwk = dw.weight.detach().float().reshape(c, 3, 3)
        pwm = pw.weight.detach().float().reshape(co, c)
        k = pwm[:, :, None, None] * dwk[None]             # (Co, C, 3, 3)
        b = pw.bias.detach().float() + dw.bias.detach().float() @ pwm.t()
        self.int8 = None
        if x_scale is not None:
            folded = Conv(c, co, 3, dtype=dw.dtype).to(k.device)
            with torch.no_grad():
                folded.weight.copy_(k)
                folded.bias.copy_(b)
            self.int8 = Int8Conv(folded, x_scale)
        else:
            self.register_buffer("k", k.to(dw.dtype).float())
            self.register_buffer("b", b)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise ValueError("the dense serving graph does not train")
        if not _qualifies(self.block, x, self.min_pixels):
            return self.block(x)
        if self.int8 is not None:
            return relu6(self.int8(x))
        y = conv_nhwc(x.float(), self.k) + self.b
        return relu6(y).to(x.dtype)


def dense_quantized_apply(model: nn.Module, amax: dict[str, Any],
                          mode: str = "mxu", skip: Iterable[str] = (),
                          min_pixels: int = 16384, quantized: bool = True
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """`quantized_apply`, with each qualifying SepConvBlock's depthwise ->
    pointwise pair folded into one dense 3x3 conv: int8 when `quantized`
    and the block's Conv_0 is calibrated and not in `skip` (as emx
    decides: a skip naming only the Conv_1 leaves the pair int8), else
    float. Returns fn(x)."""
    skip = set(skip)

    def claim(mod):
        if not _fusable(mod):
            return None
        dw_path = mod.Conv_0.path
        int8 = quantized and dw_path in amax and dw_path not in skip
        return DenseSepConv(mod, min_pixels,
                            _scale_of(amax[dw_path]) if int8 else None)

    graph = quantize_convs(swap_modules(model, claim), amax, mode, skip)

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return graph(x)

    return apply_fn


def build_graph(model: nn.Module, quant: dict, mode: str | None = None,
                fused_rows: int = 0, dense: str = ""
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A bundle's int8 serving graph from its recipe `quant` (amax, mode,
    skip): dense-folded (`dense` "int8" or "bf16"), fused at
    `fused_rows`, or plain; `mode` overrides the recipe's."""
    args = dict(mode=mode or quant["mode"], skip=quant.get("skip", ()))
    if dense:
        if dense not in ("int8", "bf16"):
            raise ValueError(f"dense must be 'int8' or 'bf16', not {dense!r}")
        return dense_quantized_apply(model, quant["amax"],
                                     quantized=dense == "int8", **args)
    if fused_rows:
        return fused_quantized_apply(model, quant["amax"], rows=fused_rows,
                                     **args)
    return quantized_apply(model, quant["amax"], **args)

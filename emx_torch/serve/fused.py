"""Serving graph with qualifying SepConvBlocks fused (port of
emx/serve/fused.py).

`fused_quantized_apply` builds the int8 graph of `quantized_apply`, but
each SepConvBlock that qualifies (stride 1, rate 1, norm 'none', relu6,
at least `min_pixels` pixels) runs as one `fused_sepconv` kernel in the
activation dtype. A fused block gets no int8 round-trip: the block is
claimed before its convs are quantized, as flax's block-level
interceptor claims it before the conv-level one in `emx`.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Iterable

import torch
from torch import nn

from emx_torch.nn.blocks import SepConvBlock, relu6
from emx_torch.ops.sepconv_kernel import fused_sepconv
from emx_torch.serve.quantize import quantize_convs, swap_modules


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

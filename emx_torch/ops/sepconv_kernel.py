"""Fused separable-conv block (port of emx/ops/sepconv_kernel.py).

`fused_sepconv` computes relu6(pointwise(depthwise3x3(x) + dw_bias) +
pw_bias) on NHWC input, stride 1, rate 1, SAME zero padding, with the
roundings of the Pallas kernel `_sepconv_kernel`: the depthwise sum in
float32, rounded to the activation dtype after its bias; the pointwise
weights rounded to the activation dtype; the product accumulated in
float32, then bias, clip and a cast to x.dtype.

On a CUDA tensor it launches the hand-written kernel in
`emx_torch/csrc/sepconv.cu` (bf16 activations) or raises; on a CPU
tensor it computes `sepconv_reference`, the plain version.

`sepconv_plan` is the kernel's schedule, computed here from the shapes
and the card's SM count and occupancy: outputs per tensor-core pass,
channels per window pass, shared-memory bytes, row band and grid.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from collections.abc import Callable

import torch
import torch.nn.functional as F

from emx_torch.ops import _build
from emx_torch.utils.device import sm_count

_count_lock = threading.Lock()

TP = 128                # pixels per tile along W (sepconv.cu)
SMEM_LIMIT = 232_448    # dynamic shared memory a block may opt into (H100)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def outputs_per_pass(co: int) -> int:
    """Outputs of one tensor-core pass: 32, 64 or 128 (the kernel's
    template parameter NT8 = this / 16)."""
    return 32 if co <= 32 else 64 if co <= 64 else 128


def smem_bytes(kc: int, nc: int) -> int:
    """Dynamic shared memory of sepconv.cu's layout(kc, nc): the window
    (3 rows x (TP + 2) pixels x kc bf16), the h tile and the weight tile
    (row pad 8), the output tile, dw, dw_b and pw_b in f32."""
    return (3 * (TP + 2) * kc * 2 + TP * (kc + 8) * 2 + nc * (kc + 8) * 2
            + TP * (nc + 8) * 2 + 9 * kc * 4 + kc * 4 + nc * 4)


def channel_chunk(c: int, nc: int) -> int:
    """Channels per window pass: all of C rounded up to 16 when that fits
    in shared memory, else the fewest equal passes of a multiple of 16
    that fit (the chunked schedule)."""
    kp = _cdiv(c, 16) * 16
    if smem_bytes(kp, nc) <= SMEM_LIMIT:
        return kp
    kmax = 16
    while smem_bytes(kmax + 16, nc) <= SMEM_LIMIT:
        kmax += 16
    return _cdiv(_cdiv(kp, _cdiv(kp, kmax)), 16) * 16


@dataclasses.dataclass(frozen=True)
class SepconvPlan:
    kc: int       # channels per window pass
    nc: int       # outputs per tensor-core pass
    smem: int     # dynamic shared-memory bytes per block
    tiles: int    # pixel tiles along W
    band: int     # output rows per work item
    items: int    # work items: B x bands x tiles
    grid: int     # persistent blocks


def sepconv_plan(b: int, h: int, w: int, c: int, co: int, sms: int,
                 blocks_per_sm: Callable[[int, int], int]) -> SepconvPlan:
    """The kernel's schedule on a card of `sms` SMs. `blocks_per_sm(co,
    smem)` is the occupancy query; the grid is that many blocks on each
    SM, capped by the work, and the band spreads the B x H rows of every
    pixel tile evenly over it (B=8 at 128x128 on 132 SMs: 8 rows; B=1: 1
    row)."""
    nc = outputs_per_pass(co)
    kc = channel_chunk(c, nc)
    smem = smem_bytes(kc, nc)
    per_sm = blocks_per_sm(co, smem)
    if per_sm <= 0:
        raise RuntimeError(f"sepconv kernel does not fit on an SM with "
                           f"{smem} bytes of shared memory")
    blocks = per_sm * sms
    tiles = _cdiv(w, TP)
    band = min(h, max(1, _cdiv(b * h * tiles, blocks)))
    items = b * _cdiv(h, band) * tiles
    return SepconvPlan(kc, nc, smem, tiles, band, items, min(blocks, items))


def sepconv_reference(x: torch.Tensor, dw_kernel: torch.Tensor,
                      dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                      pw_bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same roundings."""
    b, h, w, c = x.shape
    dw = dw_kernel.reshape(3, 3, c).float()
    pw = pw_kernel.reshape(c, -1)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            acc = acc + xp[:, ky:ky + h, kx:kx + w, :] * dw[ky, kx]
    hbuf = (acc + dw_bias.float()).to(x.dtype)
    y = hbuf.float().reshape(-1, c) @ pw.to(x.dtype).float()
    y = torch.clamp(y + pw_bias.float(), 0.0, 6.0)
    return y.reshape(b, h, w, -1).to(x.dtype)


@functools.cache
def _launcher():
    fn = _build.load("sepconv").lib.emx_sepconv_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _blocks_per_sm(device_index: int, co: int, smem: int) -> int:
    fn = _build.load("sepconv").lib.emx_sepconv_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(co, smem, ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"sepconv occupancy query failed: CUDA error {err}")
    return blocks.value


@functools.lru_cache(maxsize=512)
def card_plan(device_index: int, b: int, h: int, w: int, c: int,
              co: int) -> SepconvPlan:
    """`sepconv_plan` on this card, once per shape."""
    return sepconv_plan(b, h, w, c, co, sm_count(device_index),
                        functools.partial(_blocks_per_sm, device_index))


def fused_sepconv(x: torch.Tensor, dw_kernel: torch.Tensor,
                  dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                  pw_bias: torch.Tensor, rows: int = 32) -> torch.Tensor:
    """relu6(pointwise(depthwise3x3(x) + dw_bias) + pw_bias), fused.

    x: (B, H, W, C) NHWC; dw_kernel: (3, 3, 1, C) or (3, 3, C) (flax
    depthwise HWIO); pw_kernel: (1, 1, C, Co) or (C, Co); biases (C,)
    and (Co,). Returns (B, H, W, Co) in x.dtype. `rows` must divide H
    (the Pallas kernel's row band; the CUDA kernel picks its own band,
    see `sepconv_plan`).
    `fused_sepconv.launches` counts kernel launches.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if rows <= 0 or h % rows:
        raise ValueError(f"rows={rows} must divide H={h}")
    dw = dw_kernel.reshape(3, 3, c)
    pw = pw_kernel.reshape(c, -1)
    co = pw.shape[1]
    if tuple(dw_bias.shape) != (c,) or tuple(pw_bias.shape) != (co,):
        raise ValueError(f"bias shapes {tuple(dw_bias.shape)}, "
                         f"{tuple(pw_bias.shape)} do not fit C={c}, Co={co}")
    if x.device.type == "cpu":
        return sepconv_reference(x, dw, dw_bias, pw, pw_bias)
    if x.device.type != "cuda":
        raise ValueError(f"no sepconv kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16 x, got {x.dtype}")
    if b * h * w == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    weights = (dw, dw_bias, pw, pw_bias)
    for t in weights:
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError("weights must be float32 on x's device, got "
                            f"{t.dtype} on {t.device}")
    for t in (x, *weights):
        if not t.is_contiguous():
            raise ValueError("fused_sepconv takes contiguous tensors")
    dev = x.device.index if x.device.index is not None else \
        torch.cuda.current_device()
    plan = card_plan(dev, b, h, w, c, co)
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(dev):
        err = _launcher()(
            x.data_ptr(), dw.data_ptr(), dw_bias.data_ptr(), pw.data_ptr(),
            pw_bias.data_ptr(), out.data_ptr(), b, h, w, c, co, plan.kc,
            plan.band, plan.grid, plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sepconv kernel launch failed: CUDA error {err}")
    with _count_lock:
        fused_sepconv.launches += 1
    return out


fused_sepconv.launches = 0

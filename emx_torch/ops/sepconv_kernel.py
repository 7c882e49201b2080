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
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from emx_torch.ops import _build

_count_lock = threading.Lock()


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
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_sepconv(x: torch.Tensor, dw_kernel: torch.Tensor,
                  dw_bias: torch.Tensor, pw_kernel: torch.Tensor,
                  pw_bias: torch.Tensor, rows: int = 32) -> torch.Tensor:
    """relu6(pointwise(depthwise3x3(x) + dw_bias) + pw_bias), fused.

    x: (B, H, W, C) NHWC; dw_kernel: (3, 3, 1, C) or (3, 3, C) (flax
    depthwise HWIO); pw_kernel: (1, 1, C, Co) or (C, Co); biases (C,)
    and (Co,). Returns (B, H, W, Co) in x.dtype. `rows` must divide H
    (the Pallas kernel's row band; the CUDA kernel tiles by pixels).
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
    out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), dw.data_ptr(), dw_bias.data_ptr(), pw.data_ptr(),
            pw_bias.data_ptr(), out.data_ptr(), b, h, w, c, co,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sepconv kernel launch failed: CUDA error {err}")
    with _count_lock:
        fused_sepconv.launches += 1
    return out


fused_sepconv.launches = 0

"""Fused Poisson low-dose degrade (port of emx/ops/degrade_kernel.py).

`fused_poisson_degrade(seed, imgs, scales)` draws, for each image of a
(B, H, W) float32 batch, counts ~ Poisson(img * scales[i]) and rescales
them to [0, 1] per image (a constant image maps to 0.5):

  * rate < 10: CDF inversion with min(rate, 15) and 32 terms, counting
    from j = 0. emx's Pallas kernel starts comparing at j = 1 and so draws
    max(X - 1, 0); the port draws X, as emx's docstring and its reference
    promise (ROADMAP.md Queue 3);
  * rate >= 10: max(round(rate + sqrt(rate) * z), 0), z by Box-Muller.

The random bits come from Philox4x32-10 keyed by the 64-bit `seed`, with
the counter (element, image). The kernel reads the seed from a device
tensor (`seed_tensor`), so a CUDA graph that captures it draws anew on
each replay from a seed copied in; an int seed is copied there first.
On a CUDA tensor the wrapper launches the hand-written kernel in
`emx_torch/csrc/degrade.cu` or raises; on a CPU tensor it computes
`poisson_degrade_reference`, the plain version, which draws the same
Philox words and does the same arithmetic in the same order, so the two
agree element for element up to the last bit of exp, log and cos.

The kernel is one cooperative launch; `degrade_plan` is its schedule,
computed here from the shapes and the card's SM count and occupancy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
import torch

from emx_torch.ops import _build
from emx_torch.utils.device import sm_count

INV_TERMS = 32
_MASK = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # Weyl key increments

_count_lock = threading.Lock()

TILE = 4096             # elements per work item (degrade.cu)


@dataclasses.dataclass(frozen=True)
class DegradePlan:
    tiles: int      # items per image
    items: int      # B x tiles
    ipb: int        # items per block, a grid apart
    grid: int       # blocks of the cooperative launch


def degrade_plan(b: int, hw: int, sms: int, blocks_per_sm: int
                 ) -> DegradePlan:
    """The kernel's schedule on a card of `sms` SMs, each holding
    `blocks_per_sm` blocks (the occupancy query): the co-resident grid
    takes the items in equal shares."""
    if blocks_per_sm <= 0:
        raise RuntimeError("the degrade kernel does not fit on an SM")
    tiles = -(-hw // TILE)
    items = b * tiles
    ipb = -(-items // (blocks_per_sm * sms))
    return DegradePlan(tiles, items, ipb, -(-items // ipb))


def _mulhilo(a: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * x for a uint32 constant `a` and
    int64 `x` holding uint32 values, without overflowing int64: x is
    split into 16-bit halves, so every partial product stays below 2^49."""
    p_lo = a * (x & 0xFFFF)
    p_hi = a * (x >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32_10(counter, key: tuple[int, int]):
    """Philox4x32-10 on int64 tensors (or ints) holding uint32 words:
    four counter words and two key words -> four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> [0, 1) from 23 mantissa bits (_uniform_from_bits)."""
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return one_to_two.view(torch.float32) - 1.0


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must lie in [0, 2^64), got {seed}")
    return seed


def poisson_counts_reference(seed: int, imgs: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """The kernel's counts before the rescale, in plain PyTorch: the same
    Philox words and the same float32 operations in the same order."""
    seed = _check_seed(seed)
    b, h, w = imgs.shape
    dev = imgs.device
    elem = torch.arange(h * w, dtype=torch.int64, device=dev).reshape(1, h, w)
    image = torch.arange(b, dtype=torch.int64, device=dev).reshape(b, 1, 1)
    bits0, bits1, _, _ = philox4x32_10(
        (elem & _MASK, elem >> 32, image, 0), (seed & _MASK, seed >> 32))
    rate = imgs * scales[:, None, None]
    u, u2 = _uniform(bits0), _uniform(bits1)

    # Small rates: count j = 0, 1, ... while u > F(j), F the CDF.
    r = torch.clamp(rate, max=15.0)
    p = torch.exp(-r)
    cdf = p
    active = u > cdf
    k_small = active.float()
    for j in range(1, INV_TERMS):
        # A tensor divisor keeps the division exact on the card (a Python
        # scalar divisor becomes a multiply by its reciprocal there).
        p = p * r / torch.full((), float(j), device=dev)
        cdf = cdf + p
        active = active & (u > cdf)
        k_small = k_small + active.float()

    # Large rates: the normal approximation, z by Box-Muller.
    radius = torch.sqrt(-2.0 * torch.log(torch.clamp(u, min=1e-12)))
    z = radius * torch.cos(6.28318530718 * u2)
    k_large = torch.round(rate + torch.sqrt(torch.clamp(rate, min=0.0)) * z)
    k_large = torch.where(k_large > 0, k_large, 0.0)

    return torch.where(rate < 10.0, k_small, k_large)


def poisson_degrade_reference(seed: int, imgs: torch.Tensor,
                              scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: its counts, rescaled to [0, 1]
    per image with the kernel's arithmetic."""
    counts = poisson_counts_reference(seed, imgs, scales)
    lo = torch.amin(counts, dim=(-2, -1), keepdim=True)
    span = torch.amax(counts, dim=(-2, -1), keepdim=True) - lo
    inv = torch.where(span > 0, 1.0 / torch.where(span > 0, span, 1.0), 0.0)
    return torch.where(span > 0, (counts - lo) * inv, 0.5)


@functools.cache
def _launcher():
    fn = _build.load("degrade").lib.emx_poisson_degrade
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def seed_tensor(seed: int, device: torch.device | str) -> torch.Tensor:
    """A 64-bit seed as the one-element int64 tensor (its two's
    complement bits) that the kernel reads its Philox key from."""
    seed = _check_seed(seed)
    return torch.tensor([seed - (1 << 64) if seed >> 63 else seed],
                        dtype=torch.int64, device=device)


def _seed_value(seed) -> int:
    """The seed in [0, 2^64) of an int or a one-element int64 tensor."""
    if torch.is_tensor(seed):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError("a seed tensor holds one int64")
        return int(seed.reshape(())) & _MASK64
    return _check_seed(seed)


@functools.cache
def _blocks_per_sm(device_index: int) -> int:
    fn = _build.load("degrade").lib.emx_degrade_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"degrade occupancy query failed: CUDA error {err}")
    return blocks.value


@functools.lru_cache(maxsize=512)
def card_plan(device_index: int, b: int, hw: int) -> DegradePlan:
    """`degrade_plan` on this card, once per shape."""
    return degrade_plan(b, hw, sm_count(device_index),
                        _blocks_per_sm(device_index))


def fused_poisson_degrade(seed, imgs: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """Degrade a (B, H, W) float32 batch with per-image dose `scales` (B,)
    float32; returns the low-dose images rescaled to [0, 1]. `seed` is an
    integer in [0, 2^64), or a one-element int64 tensor on the batch's
    device holding its bits (`seed_tensor`), which the kernel reads
    there: under CUDA graph capture it must be a tensor, so that each
    replay draws from what was copied into it. An int seed is copied to
    the card first; both take the same entry point and draw the same
    words. `fused_poisson_degrade.launches` counts kernel launches (under
    capture, one per captured launch, not per replay)."""
    if imgs.dim() != 3:
        raise ValueError(f"imgs must be (B, H, W), got {tuple(imgs.shape)}")
    b, h, w = imgs.shape
    if tuple(scales.shape) != (b,):
        raise ValueError(f"scales must be ({b},), got {tuple(scales.shape)}")
    if imgs.dtype != torch.float32 or scales.dtype != torch.float32:
        raise TypeError(f"imgs and scales must be float32, got {imgs.dtype} "
                        f"and {scales.dtype}")
    if scales.device != imgs.device:
        raise ValueError(f"scales on {scales.device}, imgs on {imgs.device}")
    # Checked on every device, so the CPU tests see what the kernel refuses.
    if not (imgs.is_contiguous() and scales.is_contiguous()):
        raise ValueError("fused_poisson_degrade takes contiguous tensors")
    if imgs.device.type == "cpu":
        return poisson_degrade_reference(_seed_value(seed), imgs, scales)
    if imgs.device.type != "cuda":
        raise ValueError(f"no degrade kernel for device {imgs.device}")
    if b * h * w == 0:
        raise ValueError(f"empty input {tuple(imgs.shape)}")
    if torch.is_tensor(seed):
        if (seed.device != imgs.device or seed.dtype != torch.int64
                or seed.numel() != 1):
            raise ValueError("a seed tensor holds one int64 on the batch's "
                             "device")
    elif torch.cuda.is_current_stream_capturing():
        raise ValueError("under CUDA graph capture the seed must be a "
                         "device tensor (seed_tensor)")
    else:
        seed = seed_tensor(seed, imgs.device)
    dev = imgs.device.index if imgs.device.index is not None else \
        torch.cuda.current_device()
    plan = card_plan(dev, b, h * w)
    out = torch.empty_like(imgs)
    part = torch.empty((2, plan.items), dtype=torch.float32,
                       device=imgs.device)
    with torch.cuda.device(dev):
        err = _launcher()(
            imgs.data_ptr(), scales.data_ptr(), out.data_ptr(),
            part.data_ptr(), b, h * w, seed.data_ptr(), plan.ipb, plan.grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"degrade kernel launch failed: CUDA error {err}")
    with _count_lock:
        fused_poisson_degrade.launches += 1
    return out


fused_poisson_degrade.launches = 0

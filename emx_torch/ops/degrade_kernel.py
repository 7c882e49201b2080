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
the counter (element, image_offset + image): a data-parallel rank that
degrades rows [k, k + B) of a global batch passes `image_offset=k` and
draws what one launch over the whole batch draws for those rows. The kernel reads the seed from a device
tensor (`seed_tensor`), so a CUDA graph that captures it draws anew on
each replay from a seed copied in; an int seed is copied there first.
On a CUDA tensor the wrapper launches the hand-written kernel in
`emx_torch/csrc/degrade.cu` or raises; on a CPU tensor it computes
`poisson_degrade_reference`, the plain version, which draws the same
Philox words and does the same arithmetic in the same order, so the two
agree element for element up to the last bit of exp, log and cos.

A call is a memset and two CUDA kernels on the current stream: the
counting kernel (a block per 2,048 elements of one image, the counts in
the output, each image's min and max and its finished blocks by
atomics) and the rescale, launched as its programmatic dependent, whose
blocks start on an image once its counting blocks have finished.
`degrade_plan` is their grids, computed here from the shapes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
import torch

from emx_torch.ops import _build

INV_TERMS = 32
_MASK = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # Weyl key increments

_count_lock = threading.Lock()

TILE = 2048             # elements of one image a counting block (degrade.cu)
THREADS = 256           # threads a counting block
RESCALE_TILE = 16384    # elements of one image a rescale block


@dataclasses.dataclass(frozen=True)
class DegradePlan:
    tiles: int          # counting blocks an image
    grid: int           # counting blocks: B x tiles
    rescale_tiles: int  # rescale blocks an image
    rescale_grid: int   # rescale blocks: B x rescale_tiles
    smem_bytes: int     # a counting block's static shared memory


@functools.lru_cache(maxsize=512)
def degrade_plan(b: int, hw: int) -> DegradePlan:
    """The grids of one call on a (b, H, W) batch, hw = H * W: a counting
    block per TILE elements of one image and a rescale block per
    RESCALE_TILE, as many as the shape needs (the hardware balances
    them). A counting block keeps, in shared memory, a 16-byte list entry
    for each of its TILE elements (the small-rate list fills the entries
    from the front, the large-rate list from the back), a table of
    (j, 1/j) for the CDF terms (64 rows: a load ahead of the loop's end
    stays inside), a (min, max) a warp and two counters."""
    if b <= 0 or hw <= 0:
        raise ValueError(f"empty batch: {b} images of {hw} elements")
    if hw >= 2 ** 32:
        raise ValueError(f"an image of {hw} elements: the kernel counts "
                         f"elements in 32 bits")
    tiles, rescale_tiles = -(-hw // TILE), -(-hw // RESCALE_TILE)
    if b * tiles > 2 ** 31 - 1:
        raise ValueError(f"{b} images of {hw} elements need more than "
                         f"2^31 - 1 blocks")
    smem = TILE * 16 + 2 * INV_TERMS * 8 + 2 * (THREADS // 32) * 4 + 2 * 4
    return DegradePlan(tiles, b * tiles, rescale_tiles, b * rescale_tiles,
                       smem)


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


def _check_offset(image_offset: int, b: int) -> int:
    image_offset = int(image_offset)
    if not 0 <= image_offset <= 2 ** 32 - 1 - b:
        raise ValueError(f"image_offset + batch must lie in [0, 2^32), got "
                         f"{image_offset} + {b}")
    return image_offset


def poisson_counts_reference(seed: int, imgs: torch.Tensor,
                             scales: torch.Tensor,
                             image_offset: int = 0) -> torch.Tensor:
    """The kernel's counts before the rescale, in plain PyTorch: the same
    Philox words and the same float32 operations in the same order."""
    seed = _check_seed(seed)
    b, h, w = imgs.shape
    image_offset = _check_offset(image_offset, b)
    dev = imgs.device
    elem = torch.arange(h * w, dtype=torch.int64, device=dev).reshape(1, h, w)
    image = torch.arange(image_offset, image_offset + b, dtype=torch.int64,
                         device=dev).reshape(b, 1, 1)
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
                              scales: torch.Tensor,
                              image_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: its counts, rescaled to [0, 1]
    per image with the kernel's arithmetic."""
    counts = poisson_counts_reference(seed, imgs, scales, image_offset)
    lo = torch.amin(counts, dim=(-2, -1), keepdim=True)
    span = torch.amax(counts, dim=(-2, -1), keepdim=True) - lo
    inv = torch.where(span > 0, 1.0 / torch.where(span > 0, span, 1.0), 0.0)
    return torch.where(span > 0, (counts - lo) * inv, 0.5)


@functools.cache
def _launcher():
    fn = _build.load("degrade").lib.emx_poisson_degrade
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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


@functools.lru_cache(maxsize=8)
def kernel_attributes(device_index: int) -> dict:
    """Of each CUDA kernel of a call on this card (`count`, `rescale`):
    static shared bytes, registers a thread, local (stack and spill)
    bytes a thread, and the blocks that fit on an SM."""
    fn = _build.load("degrade").lib.emx_degrade_attributes
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for which, name in enumerate(("count", "rescale")):
        vals = (ctypes.c_int * 4)()
        with torch.cuda.device(device_index):
            err = fn(which, vals)
        if err:
            raise RuntimeError(f"degrade kernel attributes: CUDA error {err}")
        out[name] = dict(zip(("smem_bytes", "registers", "local_bytes",
                              "blocks_per_sm"), vals))
    return out


def division_mismatches(device: torch.device | str) -> tuple[int, int]:
    """The kernel's division of a CDF term by j against `__fdiv_rn`, on
    every 32-bit float x and every j in [1, 31] on the card: (the (x, j)
    pairs whose bits differ, the patterns x that take the multiply path
    and not the divide)."""
    fn = _build.load("degrade").lib.emx_degrade_division_mismatches
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    device = torch.device(device)
    tally = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = fn(tally.data_ptr())
    if err:
        raise RuntimeError(f"division check failed: CUDA error {err}")
    bad, fast = tally.tolist()
    return bad, fast


def _check_args(imgs: torch.Tensor, scales: torch.Tensor) -> None:
    if imgs.dim() != 3:
        raise ValueError(f"imgs must be (B, H, W), got {tuple(imgs.shape)}")
    b = imgs.shape[0]
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


def _launch(phases: int, seed: torch.Tensor, imgs: torch.Tensor,
            scales: torch.Tensor, image_offset: int, out: torch.Tensor,
            minmax: torch.Tensor) -> None:
    """Phase 1 (memset, counts into `out`), 2 (rescale `out` in place)
    or 3 (both) of a call, on the current stream."""
    b, h, w = imgs.shape
    dev = imgs.device.index if imgs.device.index is not None else \
        torch.cuda.current_device()
    plan = degrade_plan(b, h * w)
    with torch.cuda.device(dev):
        err = _launcher()(
            imgs.data_ptr(), scales.data_ptr(), out.data_ptr(),
            minmax.data_ptr(), b, h * w, seed.data_ptr(), image_offset,
            plan.tiles, plan.rescale_tiles, phases,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"degrade kernel launch failed: CUDA error {err}")


def fused_poisson_degrade(seed, imgs: torch.Tensor, scales: torch.Tensor,
                          image_offset: int = 0) -> torch.Tensor:
    """Degrade a (B, H, W) float32 batch with per-image dose `scales` (B,)
    float32; returns the low-dose images rescaled to [0, 1]. `seed` is an
    integer in [0, 2^64), or a one-element int64 tensor on the batch's
    device holding its bits (`seed_tensor`), which the kernel reads
    there: under CUDA graph capture it must be a tensor, so that each
    replay draws from what was copied into it. An int seed is copied to
    the card first; both take the same entry point and draw the same
    words. `image_offset` is the batch's first image in a larger batch
    (an int: a captured launch keeps it). `fused_poisson_degrade.launches`
    counts the calls that launched on the card, each a memset and two
    CUDA kernels (under capture, one per captured call, not per replay)."""
    _check_args(imgs, scales)
    b, h, w = imgs.shape
    image_offset = _check_offset(image_offset, b)
    if imgs.device.type == "cpu":
        return poisson_degrade_reference(_seed_value(seed), imgs, scales,
                                         image_offset)
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
    out = torch.empty_like(imgs)
    minmax = torch.empty(3 * b, dtype=torch.int32, device=imgs.device)
    _launch(3, seed, imgs, scales, image_offset, out, minmax)
    with _count_lock:
        fused_poisson_degrade.launches += 1
    return out


fused_poisson_degrade.launches = 0


def phase_calls(seed: torch.Tensor, imgs: torch.Tensor,
                scales: torch.Tensor) -> dict:
    """For timing each CUDA kernel of a call alone on the card: `count`
    (the memset and the counting kernel) and `rescale` (the rescale
    kernel, in place on the counts of the call made here first), each a
    callable that launches it on fixed buffers. Not counted in
    `fused_poisson_degrade.launches`."""
    _check_args(imgs, scales)
    if imgs.device.type != "cuda":
        raise ValueError("phase_calls launches the kernels on the card")
    out = torch.empty_like(imgs)
    minmax = torch.empty(3 * imgs.shape[0], dtype=torch.int32,
                         device=imgs.device)
    _launch(3, seed, imgs, scales, 0, out, minmax)
    return {"count": lambda: _launch(1, seed, imgs, scales, 0, out, minmax),
            "rescale": lambda: _launch(2, seed, imgs, scales, 0, out,
                                       minmax)}

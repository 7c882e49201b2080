"""The port's fused_sepconv against emx's Pallas kernel in interpret mode.

On the CPU the port's wrapper computes its plain version, which repeats
the Pallas kernel's roundings (depthwise sum in f32, rounded to the
activation dtype after its bias; pointwise weights rounded to the
activation dtype; f32 accumulation). tests/test_torch_gpu.py holds the
CUDA kernel against that plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.ops.sepconv_kernel import fused_sepconv as pallas_sepconv
from emx_torch.ops.sepconv_kernel import (SMEM_LIMIT, channel_chunk,
                                          fused_sepconv, outputs_per_pass,
                                          sepconv_plan, sepconv_reference,
                                          smem_bytes)

# (B, H, W, C, Co, rows): tests/test_ops_sepconv.py's shapes plus a
# ragged C=20 -> Co=24 on a non-square image.
SHAPES = [(2, 32, 32, 16, 32, 16), (2, 64, 64, 8, 8, 16),
          (1, 32, 32, 8, 8, 8), (1, 24, 20, 20, 24, 8)]


def _inputs(shape, seed=0):
    b, h, w, c, co, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, w, c)).astype(np.float32),
            rng.normal(0, 0.3, (3, 3, 1, c)).astype(np.float32),
            rng.normal(0, 0.1, (c,)).astype(np.float32),
            rng.normal(0, 0.3, (1, 1, c, co)).astype(np.float32),
            rng.normal(0, 0.1, (co,)).astype(np.float32))


def _both(shape, jdtype, tdtype):
    x, dw, dwb, pw, pwb = _inputs(shape)
    rows = shape[-1]
    ref = pallas_sepconv(jnp.asarray(x, jdtype), jnp.asarray(dw),
                         jnp.asarray(dwb), jnp.asarray(pw), jnp.asarray(pwb),
                         rows=rows, interpret=True)
    got = fused_sepconv(torch.from_numpy(x).to(tdtype),
                        *(torch.from_numpy(a) for a in (dw, dwb, pw, pwb)),
                        rows=rows)
    assert got.dtype == tdtype
    return got.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_f32_matches_pallas(shape):
    # f32 throughout: only the order of the pointwise sums differs.
    got, ref = _both(shape, jnp.float32, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bf16_matches_pallas(shape):
    # Both round the depthwise result and the pointwise weights to bf16
    # and accumulate in f32; the sums run in other orders, so an output
    # may round to the neighbouring bf16 value (2^-7 relative).
    got, ref = _both(shape, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_array_less(np.abs(got - ref),
                                 2 ** -7 * np.abs(ref) + 1e-3)


def test_plain_version_rounds_like_pallas():
    """The plain version rounds the depthwise intermediate to bf16, as
    the Pallas kernel does and emx's unrounded twin does not: with bf16
    x, rounding it or not moves outputs by more than one bf16 step."""
    x, dw, dwb, pw, pwb = _inputs((1, 16, 16, 32, 32, 8), seed=3)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = [torch.from_numpy(a) for a in (dw, dwb, pw, pwb)]
    rounded = sepconv_reference(tx, *tw).float()
    unrounded = sepconv_reference(tx.float(), *tw)
    assert (rounded - unrounded).abs().max() > 1e-2


def test_wrapper_rejects_bad_input():
    x, dw, dwb, pw, pwb = (torch.from_numpy(a)
                           for a in _inputs((1, 16, 16, 8, 8, 8)))
    with pytest.raises(ValueError, match="rows"):
        fused_sepconv(x, dw, dwb, pw, pwb, rows=5)
    with pytest.raises(ValueError, match="bias"):
        fused_sepconv(x, dw, dwb[:4], pw, pwb, rows=8)
    with pytest.raises(ValueError, match="B, H, W, C"):
        fused_sepconv(x[0], dw, dwb, pw, pwb, rows=8)
    # No device falls back to the plain version except the CPU.
    with pytest.raises(ValueError, match="device"):
        fused_sepconv(x.to("meta"), dw, dwb, pw, pwb, rows=8)


def test_cpu_path_launches_nothing():
    before = fused_sepconv.launches
    x, dw, dwb, pw, pwb = (torch.from_numpy(a)
                           for a in _inputs((1, 16, 16, 8, 8, 8)))
    fused_sepconv(x, dw, dwb, pw, pwb, rows=8)
    assert fused_sepconv.launches == before


# The kernel's schedule (emx_torch/ops/sepconv_kernel.py::sepconv_plan),
# with a stand-in for the card's occupancy query: blocks per SM limited
# by registers (2 for passes of up to 64 outputs, 1 for 128) and by
# shared memory (1 KB reserved each, 228 KB per SM), on 132 SMs.
def _occupancy(co, smem):
    return min(1 if co > 64 else 2, 233_472 // (smem + 1024))


def test_outputs_per_pass_and_shared_memory():
    assert [outputs_per_pass(co) for co in (8, 24, 32, 33, 64, 80, 128,
                                            728)] == [32, 32, 32, 64, 64,
                                                      128, 128, 128]
    # folded.b: window 3 x 130 x 128, h and weights 128 x 136, output
    # tile 128 x 136 (bf16); dw 9 x 128, dw_b 128, pw_b 128 (f32).
    assert smem_bytes(128, 128) == (3 * 130 * 128 + 3 * 128 * 136) * 2 \
        + (9 * 128 + 128 + 128) * 4 == 209_920
    for kc in range(16, 257, 16):
        for nc in (32, 64, 128):
            assert smem_bytes(kc, nc) % 16 == 0


@pytest.mark.parametrize("c,nc,kc", [(16, 64, 16), (20, 32, 32), (64, 64, 64),
                                     (80, 128, 80), (128, 128, 128),
                                     (728, 128, 128), (2048, 32, 192)])
def test_channel_chunk(c, nc, kc):
    """All of C (rounded up to 16) when it fits; else the fewest equal
    chunks of a multiple of 16, which still cover C and fit."""
    assert channel_chunk(c, nc) == kc
    assert kc % 16 == 0 and smem_bytes(kc, nc) <= SMEM_LIMIT
    assert -(-c // kc) * kc >= c


# (B, H, W, C, Co) -> (kc, nc, band, grid): the six flagship blocks at B=8
# and B=1, and off-path shapes: two pixel tiles, 728 channels.
PLANS = [
    ((8, 128, 128, 16, 64), (16, 64, 4, 256)),
    ((8, 128, 128, 64, 64), (64, 64, 4, 256)),
    ((8, 128, 128, 128, 64), (128, 64, 8, 128)),
    ((8, 128, 128, 80, 128), (80, 128, 8, 128)),
    ((8, 128, 128, 128, 128), (128, 128, 8, 128)),
    ((1, 128, 128, 128, 128), (128, 128, 1, 128)),
    ((1, 128, 128, 16, 64), (16, 64, 1, 128)),
    ((2, 300, 200, 20, 24), (32, 32, 5, 240)),
    ((1, 32, 32, 728, 728), (128, 128, 1, 32)),
]


@pytest.mark.parametrize("shape,expected", PLANS, ids=str)
def test_sepconv_plan(shape, expected):
    b, h, w, c, co = shape
    plan = sepconv_plan(b, h, w, c, co, 132, _occupancy)
    assert (plan.kc, plan.nc, plan.band, plan.grid) == expected
    assert plan.smem == smem_bytes(plan.kc, plan.nc) <= SMEM_LIMIT
    assert plan.grid <= 132 * _occupancy(co, plan.smem)


@pytest.mark.parametrize("shape", [(3, 211, 30, 32, 48),
                                   (8, 128, 128, 80, 128),
                                   (2, 300, 200, 20, 24), (5, 7, 129, 8, 8)],
                         ids=str)
def test_sepconv_plan_covers_every_row_once(shape):
    """The kernel's decoding of work items (item -> tile, band, image;
    band -> rows y0 .. min(y0 + band, H)) over its persistent grid
    produces every (image, row, pixel tile) exactly once, also when the
    band does not divide H."""
    b, h, w, c, co = shape
    plan = sepconv_plan(b, h, w, c, co, 132, _occupancy)
    bands = -(-h // plan.band)
    seen = []
    for block in range(plan.grid):
        for item in range(block, plan.items, plan.grid):
            tile, rest = item % plan.tiles, item // plan.tiles
            band, image = rest % bands, rest // bands
            y0 = band * plan.band
            seen += [(image, y, tile)
                     for y in range(y0, min(y0 + plan.band, h))]
    assert sorted(seen) == [(i, y, t) for i in range(b) for y in range(h)
                            for t in range(-(-w // 128))]


def test_sepconv_plan_needs_a_block_per_sm():
    with pytest.raises(RuntimeError, match="does not fit"):
        sepconv_plan(8, 128, 128, 128, 128, 132, lambda co, smem: 0)

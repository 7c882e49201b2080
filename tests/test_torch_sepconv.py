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
from emx_torch.ops.sepconv_kernel import fused_sepconv, sepconv_reference

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

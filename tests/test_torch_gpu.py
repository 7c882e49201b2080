"""Card-only tests of the port's CUDA kernels (marker `gpu`).

They skip without a card. On the machine with the card, which has no
JAX, run them without the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from emx_torch.ops.sepconv_kernel import fused_sepconv, sepconv_reference

# (B, H, W, C, Co, rows): small and ragged shapes, a flagship fused
# block (folded head, 80 -> 128) and the widest off-flagship tile.
SHAPES = [(2, 32, 32, 16, 32, 16), (1, 24, 20, 20, 24, 8),
          (1, 130, 66, 20, 24, 26), (8, 128, 128, 80, 128, 32),
          (1, 32, 32, 728, 728, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    b, h, w, c, co, _ = shape
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(0, 6, (b, h, w, c)), rng.normal(0, 0.3, (3, 3, 1, c)),
            rng.normal(0, 0.1, (c,)), rng.normal(0, c ** -0.5, (1, 1, c, co)),
            rng.normal(0, 0.1, (co,)))
    x, *ws = (torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs)
    return x.to(torch.bfloat16), *ws


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain_version(cuda, shape):
    # One bf16 step of the output: the kernel sums the pointwise product
    # in another order than the plain version's matmul.
    x, dw, dwb, pw, pwb = _inputs(shape, cuda)
    before = fused_sepconv.launches
    got = fused_sepconv(x, dw, dwb, pw, pwb, rows=shape[-1]).float()
    torch.cuda.synchronize()
    assert fused_sepconv.launches == before + 1
    ref = sepconv_reference(x, dw, dwb, pw, pwb).float()
    assert bool(((got - ref).abs() <= 2 ** -7 * ref.abs() + 1e-3).all())


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, dw, dwb, pw, pwb = _inputs((1, 16, 16, 8, 8, 8), cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_sepconv(x.float(), dw, dwb, pw, pwb, rows=8)
    with pytest.raises(TypeError, match="float32"):
        fused_sepconv(x, dw.half(), dwb, pw, pwb, rows=8)
    with pytest.raises(ValueError, match="contiguous"):
        fused_sepconv(x.transpose(1, 2), dw, dwb, pw, pwb, rows=8)

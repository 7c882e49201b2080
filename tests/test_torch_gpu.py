"""Card-only tests of the port's CUDA kernels and of a train step on the
card (marker `gpu`).

They skip without a card. On the machine with the card, which has no
JAX, run them without the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from emx_torch.data import denoiser_example, synthetic_micrographs
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.ops.degrade_kernel import (fused_poisson_degrade,
                                          poisson_degrade_reference)
from emx_torch.ops.sepconv_kernel import fused_sepconv, sepconv_reference
from emx_torch.train import TrainConfig, Trainer

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


# K2: the CUDA kernel draws the plain version's Philox words and does its
# arithmetic in the same order; only an ulp of expf/logf/cosf may flip a
# CDF comparison or a round: at most 1e-4 of the elements differ, and the
# per-image means agree within 1e-4.
DEGRADE_SHAPES = [(1, 1, 1), (3, 17, 33), (2, 64, 64), (16, 512, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DEGRADE_SHAPES, ids=str)
def test_degrade_kernel_matches_plain_version(cuda, shape):
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.random(shape).astype(np.float32)).to(cuda)
    scales = torch.from_numpy(
        (25 + 75 * rng.exponential(size=shape[0])).astype(np.float32)
    ).to(cuda)
    before = fused_poisson_degrade.launches
    got = fused_poisson_degrade(2 ** 40 + 9, imgs, scales)
    torch.cuda.synchronize()
    assert fused_poisson_degrade.launches == before + 1
    ref = poisson_degrade_reference(2 ** 40 + 9, imgs, scales)
    assert float((got != ref).double().mean()) <= 1e-4
    assert float((got.mean(dim=(1, 2)) - ref.mean(dim=(1, 2))).abs().max()) \
        <= 1e-4
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.5, 5.0, 9.5, 10.5, 200.0])
def test_degrade_kernel_constant_rates(cuda, rate):
    imgs = torch.ones((2, 256, 256), device=cuda)
    scales = torch.full((2,), rate, device=cuda)
    got = fused_poisson_degrade(5, imgs, scales)
    ref = poisson_degrade_reference(5, imgs, scales)
    torch.cuda.synchronize()
    assert float((got != ref).double().mean()) <= 1e-4


@pytest.mark.gpu
def test_degrade_kernel_rejects_what_it_does_not_take(cuda):
    imgs, scales = torch.rand(2, 8, 8, device=cuda), torch.ones(2, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fused_poisson_degrade(0, imgs.half(), scales)
    with pytest.raises(ValueError, match="contiguous"):
        fused_poisson_degrade(0, imgs.transpose(1, 2), scales)
    with pytest.raises(ValueError, match="scales"):
        fused_poisson_degrade(0, imgs, scales.cpu())


@pytest.mark.gpu
def test_train_step_on_the_card(cuda):
    """One step of a small bf16 BatchNorm Denoiser with the example
    synthesis on the card: K2 launches once, the loss is finite and the
    parameters move."""
    cfg = dataclasses.replace(DenoiserConfig.tiny(), norm="batch",
                              dtype=torch.bfloat16, space_to_depth=4,
                              folded_head=16, remat_middle=True)
    model = Denoiser(cfg, device=cuda)
    trainer = Trainer(model, TrainConfig(log_every=0),
                      example_fn=denoiser_example)
    state = trainer.init()
    before_params = [p.detach().clone() for p in model.parameters()]
    batch = torch.from_numpy(synthetic_micrographs(4, 64)).to(cuda)
    launches = fused_poisson_degrade.launches
    state, metrics = trainer.step_fn(state, batch)
    torch.cuda.synchronize()
    assert fused_poisson_degrade.launches == launches + 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(a, b) for a, b in
               zip(before_params, model.parameters()))

"""Card-only tests of the port's CUDA kernels and of a train step on the
card (marker `gpu`).

They skip without a card. On the machine with the card, which has no
JAX, run them without the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from emx_torch.data import denoiser_example, synthetic_micrographs
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.ops import degrade_kernel, sepconv_kernel
from emx_torch.ops.degrade_kernel import (fused_poisson_degrade,
                                          poisson_degrade_reference)
from emx_torch.ops.sepconv_kernel import fused_sepconv, sepconv_reference
from emx_torch.train import TrainConfig, Trainer
from emx_torch.utils.device import sm_count

# (B, H, W, C, Co, rows): small and ragged shapes, a flagship fused
# block (folded head, 80 -> 128) and the widest off-flagship tile.
SHAPES = [(2, 32, 32, 16, 32, 16), (1, 24, 20, 20, 24, 8),
          (1, 130, 66, 20, 24, 26), (8, 128, 128, 80, 128, 32),
          (1, 32, 32, 728, 728, 32)]

# Every edge of the kernel's schedule: C not a multiple of 16 (20) or of
# 8 (element loads), Co ragged in a pass (20, 24), W of two pixel tiles
# (200, the second ragged) and of one ragged tile (66), B x H not a
# multiple of the band (3 x 211), Co > 128 over several passes, the six
# flagship blocks at B=1, and 728 -> 728 on the channel-chunked schedule.
SCHEDULE_SHAPES = [
    (1, 9, 40, 20, 20, 9), (2, 17, 66, 16, 24, 17), (1, 12, 200, 64, 64, 12),
    (1, 8, 200, 20, 24, 8), (3, 211, 30, 32, 48, 211),
    (2, 10, 24, 36, 200, 10),
    (1, 128, 128, 16, 64, 32), (1, 128, 128, 64, 64, 32),
    (1, 128, 128, 128, 64, 32), (1, 128, 128, 80, 128, 32),
    (1, 128, 128, 128, 128, 32), (1, 16, 16, 728, 728, 16),
]


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
@pytest.mark.parametrize("shape", SCHEDULE_SHAPES, ids=str)
def test_kernel_schedule_edges(cuda, shape):
    """The same bound at every edge of the schedule, and the bf16 h
    exact: with a 1x1 identity pointwise weight and zero biases the
    output is relu6(h), which the plain version computes exactly."""
    x, dw, dwb, pw, pwb = _inputs(shape, cuda, seed=2)
    b, h, w, c, co, rows = shape
    got = fused_sepconv(x, dw, dwb, pw, pwb, rows=rows).float()
    ref = sepconv_reference(x, dw, dwb, pw, pwb).float()
    torch.cuda.synchronize()
    assert bool(((got - ref).abs() <= 2 ** -7 * ref.abs() + 1e-3).all())
    eye = torch.eye(c, device=cuda)[None, None]
    zero = torch.zeros(c, device=cuda)
    got = fused_sepconv(x, dw, dwb, eye, zero, rows=rows)
    ref = sepconv_reference(x, dw, dwb, eye, zero)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.gpu
def test_kernel_plan_on_the_card(cuda):
    """The card's occupancy gives the planned schedule: the flagship
    widest block keeps its whole window on chip, 728 channels chunk."""
    dev = torch.cuda.current_device()
    sms = sm_count(dev)
    occ = functools.partial(sepconv_kernel._blocks_per_sm, dev)
    wide = sepconv_kernel.sepconv_plan(8, 128, 128, 128, 128, sms, occ)
    assert wide.kc == 128 and wide.grid <= sms * occ(128, wide.smem)
    assert sepconv_kernel.sepconv_plan(1, 32, 32, 728, 728, sms,
                                       occ).kc < 728
    ragged = sepconv_kernel.sepconv_plan(3, 211, 30, 32, 48, sms, occ)
    assert ragged.band > 1 and 211 % ragged.band


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
@pytest.mark.parametrize("shape", [(40, 512, 512), (1, 7, 5)], ids=str)
def test_degrade_kernel_large_and_tiny_batches(cuda, shape):
    """A batch that gives each block of the co-resident grid several
    items (40 images of 512x512) and a tiny one (one partial item); each
    is one launch and identical to the plain version on every element."""
    dev = torch.cuda.current_device()
    plan = degrade_kernel.card_plan(dev, shape[0], shape[1] * shape[2])
    assert plan.grid * plan.ipb >= plan.items
    assert plan.grid <= sm_count(dev) * degrade_kernel._blocks_per_sm(dev)
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.random(shape).astype(np.float32)).to(cuda)
    scales = torch.from_numpy(
        (25 + 75 * rng.exponential(size=shape[0])).astype(np.float32)
    ).to(cuda)
    before = fused_poisson_degrade.launches
    got = fused_poisson_degrade(77, imgs, scales)
    torch.cuda.synchronize()
    assert fused_poisson_degrade.launches == before + 1
    assert torch.equal(got, poisson_degrade_reference(77, imgs, scales))


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

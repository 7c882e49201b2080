"""Card-only tests of the port's CUDA kernels, of a train step on the
card, and of the serving modules' device paths (marker `gpu`).

They skip without a card. On the machine with the card, which has no
JAX, run them without the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from emx_torch.analysis.filters import DEFAULT_FILTERS
from emx_torch.bench.ladders import load_ladder
from emx_torch.data import denoiser_example, synthetic_micrographs
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.nn.blocks import Conv
from emx_torch.nn.denoiser import FoldedHeadTail
from emx_torch.nn.init import init_parameters
from emx_torch.ops import degrade_kernel, sepconv_kernel
from emx_torch.ops.degrade_kernel import (fused_poisson_degrade,
                                          poisson_degrade_reference)
from emx_torch.ops.sepconv_kernel import fused_sepconv, sepconv_reference
from emx_torch.serve.quantize import (Int8DepthwiseConv, calibrate,
                                      fake_quant_apply)
from emx_torch.serve.select import auto_denoise, serving_candidates
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


@pytest.mark.gpu
def test_int8_depthwise_on_the_card_is_exact(cuda):
    """'mxu2' depthwise: integer sums are exact in float32 (TF32 on or
    off), so the card gives the CPU's output bit for bit."""
    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator().manual_seed(0)
    conv = Conv(64, 64, 3, groups=64)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
        conv.bias.copy_(torch.randn(64, generator=gen))
    x = 3 * torch.rand((2, 40, 36, 64), generator=gen)
    scale = x.abs().amax(dim=(0, 1, 2)) / 127.0
    ref = Int8DepthwiseConv(conv, scale)(x)
    got = Int8DepthwiseConv(conv.to(cuda), scale.to(cuda))(x.to(cuda))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DEFAULT_FILTERS))
def test_filter_on_the_card_matches_cpu(cuda, name):
    x = torch.rand((3, 96, 80), generator=torch.Generator().manual_seed(1))
    ref = DEFAULT_FILTERS[name](x)
    got = DEFAULT_FILTERS[name](x.to(cuda)).cpu()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_ctf_ladder_on_the_card_matches_cpu(cuda):
    """The ctf family renders on torch.fft: the card's ladder within 1e-5
    of the CPU's; the noisy images are the same counts, exactly."""
    n_cpu, t_cpu = load_ladder("ood_ctf", "cpu")
    n_gpu, t_gpu = load_ladder("ood_ctf", cuda)
    assert torch.equal(n_gpu.cpu(), n_cpu)
    torch.testing.assert_close(t_gpu.cpu(), t_cpu, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_auto_denoise_on_the_card(cuda):
    """Each image's output is its chosen candidate's, on the card."""
    noisy, _ = load_ladder("val", cuda)
    names, cands = serving_candidates(lambda b: b * 0.5 + 0.25)
    out, chosen = auto_denoise(noisy[:6], cands, seed=0, n_masks=2)
    each = torch.stack([fn(noisy[:6]) for fn in cands])
    for i, c in enumerate(chosen.tolist()):
        assert torch.equal(out[i], each[c, i])
    assert chosen.device.type == "cuda" and len(names) == len(cands)


def _fake_quant_loss(model, amax, mode, x, target):
    """The fake-quant output and each parameter's gradient of its mean
    squared error to `target`, on the model's device."""
    model.zero_grad(set_to_none=True)
    out = fake_quant_apply(model, amax, mode)(model, x)
    torch.mean((out - target) ** 2).backward()
    # Copies: moving the model moves the .grad tensors with it.
    return out.detach().cpu().clone(), {
        n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["store", "mxu", "mxu2"])
def test_fake_quant_on_the_card_matches_cpu(cuda, mode):
    """fake_quant_apply on the card against its CPU result on the same
    float32 model and inputs: outputs within the int8 grid tolerance of
    tests/test_torch_qat.py (a value on a grid midpoint may take the
    neighbouring level), gradients per parameter within 3e-2 of their
    norm (1e-4 in 'store', which has no weight grid). TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(DenoiserConfig.tiny(), norm="none",
                              space_to_depth=4, folded_head=16)
    model = init_parameters(Denoiser(cfg, device="cpu"),
                            torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((2, 64, 64), generator=gen)
    target = 0.25 + 0.5 * torch.rand((2, 64, 64), generator=gen)
    amax = calibrate(model, [x])
    ref_out, ref_g = _fake_quant_loss(model, amax, mode, x, target)
    out, g = _fake_quant_loss(model.to(cuda), amax, mode, x.to(cuda),
                              target.to(cuda))
    err = (out - ref_out).abs()
    assert float(err.mean()) < 1e-5 and float(err.max()) < 1e-3
    tol = 1e-4 if mode == "store" else 3e-2
    for name, ref in ref_g.items():
        scale = max(float(ref.norm()), 1e-12)
        assert float((g[name] - ref).norm()) / scale < tol, name


@pytest.mark.gpu
def test_tail_distill_step_on_the_card(cuda):
    """One fake-quant step of a decoder2 tail in bf16 on the card: the
    loss equals the CPU's within bf16 rounding, is finite, and the Adam
    step moves the parameters."""
    from emx_torch.bench.qat_finetune import adam
    from emx_torch.train.losses import huberised_mse

    cfg = dataclasses.replace(DenoiserConfig.tiny(), norm="none",
                              space_to_depth=4, folded_head=16,
                              dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(2)
    f = cfg.features
    cat = (torch.rand((2, 4, 4, cfg.aspp_out + f[1]), generator=gen),
           torch.rand((2, 8, 8, f[1]), generator=gen),
           torch.rand((2, 64, 64), generator=gen))
    tgt = torch.rand((2, 64, 64), generator=gen)
    losses = []
    for device in ("cpu", cuda):
        tail = init_parameters(FoldedHeadTail(cfg, "decoder2", device="cpu"),
                               torch.Generator().manual_seed(3)).to(device)
        inputs = tuple(t.to(device) for t in cat)
        fq = fake_quant_apply(tail, calibrate(tail, [inputs]), "mxu")
        before = [p.detach().clone() for p in tail.parameters()]
        opt = adam(tail.parameters(), 1e-3)
        loss = huberised_mse(fq(tail, inputs).float(), tgt.to(device))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        assert any(not torch.equal(a, b) for a, b in
                   zip(before, tail.parameters()))
    assert np.isfinite(losses).all()
    assert abs(losses[1] - losses[0]) <= 2e-2 * abs(losses[0])


# -- steps_per_launch: CUDA graphs of the train step ----------------------

GRAPH_CFG = dict(norm="batch", dtype=torch.bfloat16, space_to_depth=4,
                 folded_head=16, remat_middle=True)


@pytest.fixture
def deterministic(cuda):
    was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield cuda
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was


def _graph_setup(cuda, tmp_path, name, **kw):
    from emx_torch.data import DeviceDataset, PipelineConfig

    model = Denoiser(dataclasses.replace(DenoiserConfig.tiny(), **GRAPH_CFG),
                     device=cuda)
    cfg = TrainConfig(log_every=1, seed=4, model_dir=str(tmp_path / name),
                      **kw)
    trainer = Trainer(model, cfg, example_fn=denoiser_example)
    data = DeviceDataset(synthetic_micrographs(8, 64, seed=2),
                         PipelineConfig(batch_size=2, crop_size=64, seed=1),
                         device=cuda)
    return trainer, trainer.init(), data


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["nesterov", "adam"])
def test_graph_equals_eager_on_the_card(deterministic, tmp_path, optimizer):
    """6 steps eagerly and as 3 replays of a graph of 2 steps (K2 inside
    it), from the same initialisation: the same parameters, BatchNorm
    statistics and logged losses, bit for bit under cudnn.deterministic
    (the bilinear upsample's backward is a product, not atomics)."""
    cuda = deterministic
    eager, es, ed = _graph_setup(cuda, tmp_path, "e", optimizer=optimizer)
    eager.fit(es, ed, 6)
    graphed, gs, gd = _graph_setup(cuda, tmp_path, "g", optimizer=optimizer,
                                   steps_per_launch=2)
    launches = fused_poisson_degrade.launches
    graphed.fit(gs, gd, 6)
    torch.cuda.synchronize()
    assert graphed.graph_stats["replays"] == 3
    assert graphed.graph_stats["captures"] == 1
    assert graphed.graph.k2_per_replay == 2
    # Two warm-up steps and the two captured launches.
    assert fused_poisson_degrade.launches == launches + 4
    a, b = _params(es), _params(gs)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    import json

    def losses(tr):
        with open(tmp_path / tr / "metrics.jsonl") as f:
            return {ln["step"]: ln["loss"] for ln in map(json.loads, f)}

    eager_losses, graph_losses = losses("e"), losses("g")
    assert sorted(graph_losses) == [2, 4, 6]
    assert all(graph_losses[s] == eager_losses[s] for s in graph_losses)


@pytest.mark.gpu
def test_degrade_kernel_under_capture(cuda):
    """K2 captured with its seed in a device tensor: each replay, with a
    new seed copied in, equals the plain version on every element; an int
    seed under capture is refused."""
    gen = torch.Generator().manual_seed(5)
    imgs = torch.rand((3, 96, 80), generator=gen).to(cuda)
    scales = torch.tensor([4.0, 30.0, 300.0], device=cuda)
    key = degrade_kernel.seed_tensor(1, cuda)
    fused_poisson_degrade(key, imgs, scales)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_poisson_degrade(key, imgs, scales)
    for seed in (1, 2 ** 63 + 5, 2 ** 64 - 1):
        key.copy_(degrade_kernel.seed_tensor(seed, cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, poisson_degrade_reference(seed, imgs, scales))
        assert torch.equal(out, fused_poisson_degrade(seed, imgs, scales))
    with pytest.raises(ValueError, match="device tensor"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            fused_poisson_degrade(3, imgs, scales)


@pytest.mark.gpu
def test_lr_hot_reload_inside_a_graph(cuda, tmp_path):
    """learning_rate.txt between launches: Adam's learning rate is a
    device tensor the graph reads, filled in place (no recapture), and at
    0 the parameters stop moving; SGD's is a host number, so a new rate
    recaptures."""
    import os

    for optimizer, captures in (("adam", 1), ("nesterov", 2)):
        tr, state, data = _graph_setup(cuda, tmp_path, optimizer,
                                       optimizer=optimizer,
                                       steps_per_launch=2)
        tr.fit(state, data, 2)
        with open(os.path.join(tr.cfg.model_dir, "learning_rate.txt"),
                  "w") as f:
            f.write("0.0\n")
        tr.fit(state, data, 4)      # the rate is read after this launch
        before = _params(state)
        tr.fit(state, data, 6)
        after = _params(state)
        assert tr.graph_stats["captures"] == captures, optimizer
        assert all(torch.equal(before[k], after[k]) for k in before
                   if not k.endswith(("mean", "var"))), optimizer


@pytest.mark.gpu
def test_resume_under_a_graph(deterministic, tmp_path):
    """Launches of 2 with checkpoints every 2: a run restored from step 4
    into a trainer whose graph was captured on other tensors recaptures,
    and ends where an uninterrupted run to 8 ends."""
    from emx_torch.train import Checkpointer

    cuda = deterministic
    whole, ws, wd = _graph_setup(cuda, tmp_path, "whole", steps_per_launch=2)
    whole.fit(ws, wd, 8)
    first, fs, fd = _graph_setup(cuda, tmp_path, "first", steps_per_launch=2,
                                 ckpt_every_steps=2)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    first.fit(fs, fd, 4, checkpointer=ckpt)
    again, gs, gd = _graph_setup(cuda, tmp_path, "again", steps_per_launch=2)
    again.fit(gs, gd, 2)
    gs, cursor = ckpt.restore(gs)
    gd.load_state_dict(cursor)
    again.fit(gs, gd, 8)
    assert again.graph_stats["captures"] == 2
    a, b = _params(ws), _params(gs)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
def test_gan_step_on_the_card(cuda):
    """A small GAN step (generator, then discriminator) on the card against
    the same step on the CPU: the same draws, metrics within 1e-3
    relative, and every parameter within 2 lr, all but 0.1% of them
    within 1e-4 (float32; cuDNN's convolution algorithms differ from the
    CPU's in rounding). Adam's first step moves an element by
    lr g / (|g| + 1e-8): where g is rounding noise or near 1e-8 the two
    devices' steps differ by up to 2 lr. Widths of 64 (two channels a
    norm group) keep that rare: at the tiny config's one channel a group
    every conv bias before a norm is cancelled by it, and 212 elements
    of the tiny nets moved apart on an H100; at width 64, 71 of
    233,878."""
    from emx_torch.data.degrade import fixed_scan_mask, infilling_example
    from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                        MultiscaleDiscriminator)
    from emx_torch.train.gan import GANConfig, GANTrainer

    torch.backends.cudnn.allow_tf32 = False
    cfg = InfillingConfig(gen_features=(64,) * 4, nin_down=(64,) * 3,
                          nin_up=(64,) * 3, num_global_blocks=1,
                          num_local_blocks=1, disc_features=(64,) * 3)
    data = torch.from_numpy(synthetic_micrographs(2, 32, seed=21))
    mask = fixed_scan_mask((32, 32), 1 / 16)
    results = []
    for dev in ("cpu", cuda):
        trainer = GANTrainer(InfillingGenerator(cfg, device=dev),
                             MultiscaleDiscriminator(cfg, device=dev),
                             GANConfig(gen_lr=1e-3, disc_lr=1e-3,
                                       mse_weight=10.0, log_every=0),
                             example_fn=infilling_example(mask))
        state = trainer.init()
        metrics = []
        for do_gen in (True, False):
            draws = trainer.step_draws(state.step, 2, 32)
            draws["example"] = {"d4": torch.tensor([3, 6], device=dev)}
            state, m = trainer.step_fn(state, data, do_gen, not do_gen,
                                       draws=draws)
            metrics.append({k: float(v) for k, v in m.items()})
        params = [p.detach().cpu() for net in (state.gen, state.disc)
                  for p in net.parameters()]
        results.append((metrics, params))
    (m_cpu, p_cpu), (m_gpu, p_gpu) = results
    for a, b in zip(m_cpu, m_gpu):
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=1e-3, abs=1e-6), k
    d = torch.cat([(b - a).abs().reshape(-1) for a, b in zip(p_cpu, p_gpu)])
    assert float(d.max()) <= 2e-3 + 1e-6
    assert int((d > 1e-4).sum()) <= d.numel() // 1000, int((d > 1e-4).sum())


@pytest.mark.gpu
def test_reconstruct_on_the_card(cuda):
    """EWREC's GS loop and the weak-phase residual on the card (cuFFT)
    against the CPU (pocketfft): the wave within 1e-4 after 30
    iterations, the residual within 1e-4 relative."""
    from emx_torch.physics.propagate import propagate_back_to_defocus
    from emx_torch.recon import (EWRECConfig, reconstruct,
                                 weak_phase_residual)

    rng = np.random.default_rng(0)
    wave = (1.0 + 0.1 * rng.random((128, 128))) * np.exp(
        1j * 0.5 * rng.random((128, 128)))
    dfs = torch.tensor([-300.0, -150.0, 0.0, 150.0, 300.0])
    ints = torch.abs(propagate_back_to_defocus(
        torch.from_numpy(wave.astype(np.complex64)), dfs, 0.025)) ** 2
    cfg = EWRECConfig(num_iter=30)
    cpu = reconstruct(torch.sqrt(ints), dfs, cfg)
    gpu = reconstruct(torch.sqrt(ints).to(cuda), dfs.to(cuda), cfg)
    assert gpu.device.type == "cuda"
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-4)
    r_cpu = weak_phase_residual(ints, dfs, cfg)
    r_gpu = weak_phase_residual(ints.to(cuda), dfs.to(cuda), cfg)
    assert float(r_gpu) == pytest.approx(float(r_cpu), rel=1e-4, abs=1e-7)


@pytest.mark.gpu
def test_zoo_step_on_the_card(cuda):
    """Two steps of the zoo ladder's manifold family (both optimizers) on
    the card against the same steps on the CPU, from one initialisation
    and one batch: the recon losses within 1e-3 relative, every
    parameter within 2 lr (Adam's widest move, where a gradient is
    rounding noise: the conv biases ahead of an instance norm) and all
    but 0.1% within 1e-4 (float32; cuDNN's algorithms round otherwise)."""
    from emx_torch.bench import zoo_ladder as zl
    from emx_torch.nn.manifold import SharedManifoldTranslator

    torch.backends.cudnn.allow_tf32 = False
    a = torch.from_numpy(synthetic_micrographs(4, 32, seed=5))
    b = zl.to_domain_b(torch.from_numpy(synthetic_micrographs(4, 32,
                                                              seed=6)))
    results = []
    for dev in ("cpu", cuda):
        model = zl._init(SharedManifoldTranslator(zl.manifold_config(0.25),
                                                  device="cpu"), 0, dev)
        main = [p for n, p in model.named_parameters()
                if not n.startswith("confuser.")]
        m_opt = torch.optim.Adam(main, lr=2e-4)
        c_opt = torch.optim.Adam(model.confuser.parameters(), lr=2e-4)
        losses = [float(zl.manifold_step(model, m_opt, c_opt, a.to(dev),
                                         b.to(dev))) for _ in range(2)]
        results.append((losses, [p.detach().cpu()
                                 for p in model.parameters()]))
    (l_cpu, p_cpu), (l_gpu, p_gpu) = results
    assert l_gpu == pytest.approx(l_cpu, rel=1e-3)
    d = torch.cat([(g - c).abs().reshape(-1) for c, g in zip(p_cpu, p_gpu)])
    assert float(d.max()) <= 2 * 2 * 2e-4 + 1e-6
    assert int((d > 1e-4).sum()) <= d.numel() // 1000, int((d > 1e-4).sum())


@pytest.mark.gpu
def test_style_gate_on_the_card(cuda, tmp_path):
    """The style artifact cut to 100 steps on the card and on the CPU,
    from the committed inputs: gram_gap_closed and content_correlation
    within 0.005 of each other (float32, TF32 off; the phase holds the
    uncut run to the record within 0.02)."""
    from emx_torch.bench import style_artifact

    torch.backends.cudnn.allow_tf32 = False
    got = [style_artifact.main(str(tmp_path / dev), 128, 100, 2000.0,
                               device=dev)
           for dev in ("cpu", "cuda")]
    assert got[1]["seconds"] is not None and got[0]["seconds"] is None
    for k in ("gram_gap_closed_exact", "content_correlation_exact"):
        assert abs(got[1][k] - got[0][k]) <= 0.005, (k, got)


@pytest.mark.gpu
def test_scope_on_the_card(cuda):
    """The serial simulator and the vec env on the card against the same
    calls on the CPU (noiseless, away from focus: cuFFT against the
    CPU's FFT within 2e-5); the vec env's draws repeat from one seed on
    the card; the committed policy's Q values within 1e-5 with cuDNN's
    TF32 left on (q_values computes in full float32 itself)."""
    from emx_torch.scope.dqn import DQNAgent, DQNConfig, load_policy
    from emx_torch.scope.sim import SimulatedMicroscope
    from emx_torch.scope.vec_env import VecFresnelConfig, VecFresnelEnv

    torch.backends.cudnn.allow_tf32 = True      # cuDNN's default
    frames = []
    for dev in ("cpu", cuda):
        s = SimulatedMicroscope(image_size=48, seed=5, dose=0, device=dev)
        s.x, s.z, s.focus = 13.0, 0.9, 40.0
        frames.append(s.acquire())
    np.testing.assert_allclose(frames[1], frames[0], atol=2e-5)

    cfg = VecFresnelConfig(batch=8, dose=0.0)
    z = torch.tensor([0.3, -0.5, 1.2, -2.0, 0.9, 2.7, -1.1, 0.45])
    idx = torch.arange(8) * 7
    got = [VecFresnelEnv(cfg, device=dev).acquire(
        VecFresnelEnv(cfg, device=dev)._pool[idx.to(dev)], z.to(dev)).cpu()
        for dev in ("cpu", cuda)]
    torch.testing.assert_close(got[1], got[0], rtol=0, atol=2e-5)
    env = VecFresnelEnv(VecFresnelConfig(batch=8), device=cuda)
    (s1, o1), (s2, o2) = env.reset(seed=1), env.reset(seed=1)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    torch.testing.assert_close(env.step(s1, z)[1], env.step(s2, z)[1],
                               rtol=0, atol=0)

    obs = torch.from_numpy(np.random.default_rng(0).random(
        (4, 48, 48, 3), np.float32))
    q = [load_policy(DQNAgent((48, 48, 3), DQNConfig(features=(32, 64),
                                                     buffer_size=8),
                              device=dev),
                     "docs/runs/dqn_autofocus_v2/policy.npz").q_values(
        obs.to(dev)).cpu() for dev in ("cpu", cuda)]
    torch.testing.assert_close(q[1], q[0], rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 5])
def test_degrade_kernel_image_offset(cuda, offset):
    """K2 with image_offset=k on rows [k:] draws what the whole batch's
    launch draws for those rows, and what the plain version draws, on
    every element; eagerly and in a captured graph."""
    gen = torch.Generator().manual_seed(9)
    imgs = torch.rand((7, 96, 80), generator=gen).to(cuda)
    scales = (25.0 + 75.0 * torch.rand(7, generator=gen)).to(cuda)
    rows, sc = imgs[offset:].contiguous(), scales[offset:].contiguous()
    whole = fused_poisson_degrade(13, imgs, scales)
    got = fused_poisson_degrade(13, rows, sc, image_offset=offset)
    assert torch.equal(got, whole[offset:])
    assert torch.equal(got, poisson_degrade_reference(13, rows, sc, offset))
    assert not torch.equal(got, fused_poisson_degrade(13, rows, sc))
    key = degrade_kernel.seed_tensor(1, cuda)
    fused_poisson_degrade(key, rows, sc, image_offset=offset)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_poisson_degrade(key, rows, sc, image_offset=offset)
    key.copy_(degrade_kernel.seed_tensor(13, cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.fixture
def nccl_world_1(cuda):
    """A one-rank NCCL process group at a free local port."""
    import socket

    import torch.distributed as dist

    from emx_torch.parallel.distributed import initialize

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize(f"127.0.0.1:{port}", 1, 0)
    yield cuda
    dist.destroy_process_group()


@pytest.mark.gpu
def test_nccl_world_1_all_reduce(nccl_world_1):
    import torch.distributed as dist

    from emx_torch.parallel import make_mesh

    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    x = torch.arange(5.0, device=nccl_world_1)
    dist.all_reduce(x)
    assert x.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "spatial": 1}
    assert mesh.device.type == "cuda" and mesh.group("data") is not None


@pytest.mark.gpu
def test_graph_equals_eager_under_a_mesh(nccl_world_1, tmp_path):
    """Under a one-rank NCCL mesh (the gradient all-reduce and the
    loss's gather captured in the graph): 6 steps eagerly and as 3
    replays of a graph of 2 steps, bit for bit, and equal to 6 steps
    without a mesh."""
    from emx_torch.parallel import make_mesh

    was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        runs = {}
        for name, kw, mesh in (("plain", {}, None),
                               ("eager", {}, make_mesh()),
                               ("graph", {"steps_per_launch": 2},
                                make_mesh())):
            trainer, state, data = _graph_setup(nccl_world_1, tmp_path,
                                                name, **kw)
            if mesh is not None:
                trainer = Trainer(trainer.model, trainer.cfg, mesh=mesh,
                                  example_fn=denoiser_example)
            trainer.fit(state, data, 6)
            torch.cuda.synchronize()
            runs[name] = _params(state)
        for name in ("eager", "graph"):
            for k in runs["plain"]:
                assert torch.equal(runs[name][k], runs["plain"][k]), (name, k)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was

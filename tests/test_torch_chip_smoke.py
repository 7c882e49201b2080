"""CPU rehearsal of chip_smoke.py's phases on tiny configs.

Every phase runs here with device="cpu", where the kernels' wrappers
take their plain versions: load, serve over HTTP (native, tiled), output
checks, the launch counts, the PSNR report, the fused-vs-int8
comparison, the K2 comparison and its bound, training with a checkpoint
and its restore, fold, calibrate, save and serve, and the report lines.
main() is not run: it must fail without a card, which test_device_phase_
needs_a_card checks."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.serve.artifact import save_denoiser_artifact
from emx.serve.quantize import calibrate as flax_calibrate
from emx_torch.nn import DenoiserConfig


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers,
    and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    """A flagship-shaped tiny bundle (s2d 4, folded head, norm none,
    bf16, int8 mxu) and the smoke config that serves it on 64 tiles.
    Its weights are random, so the PSNR gain is reported, not gated."""
    cfg = dataclasses.replace(FlaxConfig.tiny(), norm="none",
                              space_to_depth=4, folded_head=16,
                              dtype=jnp.bfloat16)
    model = FlaxDenoiser(cfg)
    x = jnp.asarray(np.random.default_rng(0).random((2, 64, 64)),
                    jnp.float32)
    variables = model.init(jax.random.key(0), x, train=False)
    path = str(tmp_path_factory.mktemp("smoke") / "artifact_int8.npz")
    save_denoiser_artifact(path, cfg, variables, quant={
        "mode": "mxu", "amax": flax_calibrate(model, variables, [x])})
    return chip_smoke.SmokeConfig(
        bundle=path, tile=64, overlap=16, fused_rows=8, n_requests=2,
        big_shape=(100, 72), launches_per_forward=0, min_psnr_gain_db=None)


def test_serve_phase(tiny_config):
    res = chip_smoke.phase_serve(CPU, tiny_config)
    # 2 native forwards + ceil(4 windows / 8) tiled forward.
    assert res["forwards"] == 3 and res["launches"] == 0
    assert len(res["psnr_gain_db"]) == 2
    assert np.isfinite(res["psnr_gain_db"]).all()
    assert res["fused_vs_int8_psnr_db"] > 35.0
    assert res["forward_ms"] == {}          # timing needs the card


def test_serve_phase_checks_launches(tiny_config):
    cfg = dataclasses.replace(tiny_config, launches_per_forward=6)
    with pytest.raises(AssertionError, match="launched 0 times"):
        chip_smoke.phase_serve(CPU, cfg)


def test_kernel_phase_and_report_lines(capsys):
    shapes = (("tiny", 1, 16, 12, 20, 24), ("edge", 2, 8, 8, 8, 8))
    res = chip_smoke.phase_kernel(CPU, shapes=shapes)
    assert [r["name"] for r in res] == ["tiny", "edge"]
    assert all(r["max_abs_err"] == 0.0 for r in res)  # CPU: plain twice
    degrade = chip_smoke.phase_degrade(CPU, b=2, size=32)
    line = json.loads(json.dumps(chip_smoke.kernels_line(res, 7, degrade,
                                                         30)))
    k1, k2 = line["kernels"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms"}
    assert set(k1) == keys | {"b1"} and set(k2) == keys
    assert set(k1["b1"]) == set(chip_smoke.TIMED_KEYS)
    for k in (k1, k2):
        assert k["route"] == "cuda"
    assert k1["launches"] == 7 and k2["launches"] == 30
    assert k1["source"] == "emx_torch/csrc/sepconv.cu"
    assert k2["source"] == "emx_torch/csrc/degrade.cu"
    assert k2["replaces"] == "emx/ops/degrade_kernel.py:39"
    assert "[kernel] tiny" in capsys.readouterr().out


def test_bound_of_flagship_shapes():
    # folded.b: 8*128*128 px, 128 -> 128 channels. Bytes: bf16 in and
    # out plus f32 weights; it is bound by bytes at 3.35 TB/s.
    ms, by = chip_smoke.sepconv_bound_ms(8, 128, 128, 128, 128)
    px = 8 * 128 * 128
    nbytes = px * 128 * 2 * 2 + 4 * (9 * 128 + 128 + 128 * 128 + 128)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)


def test_request_data():
    rng = np.random.default_rng(0)
    clean = chip_smoke.smooth_field(rng, 64, 48)
    noisy, target = chip_smoke.degrade(rng, clean, 50.0)
    assert clean.shape == noisy.shape == target.shape == (64, 48)
    assert clean.min() == 0.0 and clean.max() == 1.0
    assert noisy.min() == 0.0 and noisy.max() == 1.0
    assert target.mean() == pytest.approx(noisy.mean(), rel=1e-5)


def test_device_phase_needs_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.phase_device(CPU)


def test_degrade_phase(capsys):
    res = chip_smoke.phase_degrade(CPU, b=2, size=48)
    # The training batch and five constant-rate images, all exact on the
    # CPU (the plain version twice); no timing without the card.
    assert len(res["checks"]) == 1 + len(chip_smoke.K2_RATES)
    assert res["max_abs_err"] == 0.0 and "ms" not in res
    assert "[degrade] constant@10.5" in capsys.readouterr().out


def test_degrade_bound():
    """At the training batch the bound is the bytes: 8 per element at
    3.35 TB/s; a rate-8 image's loop adds 5 operations per CDF term."""
    imgs = torch.full((16, 512, 512), 0.5)
    scales = torch.full((16,), 100.0)   # rate 50: the normal branch
    counts = torch.full_like(imgs, 50.0)
    ms, by = chip_smoke.degrade_bound_ms(imgs, scales, counts)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (8 * imgs.numel() + 64) / 3.35e12)
    small = torch.full((1, 2, 2), 8.0)
    ops = chip_smoke.degrade_ops(small, torch.tensor([[[0.0, 3.0],
                                                       [40.0, 8.0]]]))
    assert ops == 4 * 102 + 4 * 7 + 5 * (0 + 3 + 31 + 8)


TINY_TRAIN = chip_smoke.TrainSmokeConfig(
    model=dataclasses.replace(DenoiserConfig.tiny(), norm="batch",
                              dtype=torch.bfloat16, space_to_depth=4,
                              folded_head=16, remat_middle=True),
    n_images=8, size=64, batch=4, steps=8, window=3, k2_per_step=0)


@pytest.fixture(scope="module")
def trained():
    return chip_smoke.phase_train(CPU, TINY_TRAIN)


def test_train_phase(trained):
    """The flagship-shaped tiny model trains 8 steps through Trainer.fit:
    finite, falling loss; the halfway checkpoint restores exactly (the
    phase raises otherwise); no K2 launch on the CPU."""
    assert len(trained["losses"]) == 8 and trained["launches"] == 0
    assert np.isfinite(trained["losses"]).all()
    assert trained["peak_bytes"] == 0 and trained["step_ms"] > 0


def test_train_phase_checks_launches():
    cfg = dataclasses.replace(TINY_TRAIN, k2_per_step=1)
    with pytest.raises(AssertionError, match="K2 launched 0 times"):
        chip_smoke.phase_train(CPU, cfg)


def test_deploy_phase(trained):
    """Fold, calibrate, save and serve the trained tiny model."""
    res = chip_smoke.phase_deploy(CPU, trained, chip_smoke.DeploySmokeConfig(
        fused_rows=8, launches_per_forward=0))
    assert res["fold_psnr_db"] > 35.0 and res["launches"] == 0
    assert res["n_amax"] > 0 and np.isfinite(res["psnr_gain_db"])
    with pytest.raises(AssertionError, match="K1 launched 0 times"):
        chip_smoke.phase_deploy(CPU, trained, chip_smoke.DeploySmokeConfig(
            fused_rows=8))


def test_flagship_training_config():
    cfg = chip_smoke.TrainSmokeConfig()
    m = cfg.model
    assert (m.norm, m.dtype, m.space_to_depth, m.folded_head,
            m.remat_middle) == ("batch", torch.bfloat16, 4, 128, True)
    assert m.features == (64, 128, 256, 728, 728)
    assert (m.num_middle_blocks, m.aspp_filters, m.aspp_out) == (11, 728, 256)
    assert (cfg.batch, cfg.size, cfg.learning_rate) == (16, 512, 1e-3)

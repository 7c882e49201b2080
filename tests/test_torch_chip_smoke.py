"""CPU rehearsal of chip_smoke.py's phases on a tiny int8 bundle.

Every phase that needs no kernel runs here with device="cpu": load,
serve over HTTP (native, tiled), output checks, the launch count, the
PSNR report, the fused-vs-int8 comparison and the report lines. main()
is not run: it must fail without a card, which test_device_phase_needs_
a_card checks."""

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
    line = json.loads(json.dumps(chip_smoke.kernels_line(res, 7)))
    (k1,) = line["kernels"]
    assert set(k1) == {"name", "route", "source", "replaces", "launches",
                       "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by", "library_ms"}
    assert k1["route"] == "cuda" and k1["launches"] == 7
    assert k1["source"] == "emx_torch/csrc/sepconv.cu"
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

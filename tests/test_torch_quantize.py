"""The port's int8 serving graphs against emx's on a tiny norm-free
config, with the same amax (from emx's calibrate)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.serve.fused import fused_quantized_apply as flax_fused
from emx.serve.quantize import calibrate as flax_calibrate
from emx.serve.quantize import quantized_apply as flax_quantized
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.ops.sepconv_kernel import fused_sepconv
from emx_torch.serve.convert import load_flax_params
from emx_torch.serve.fused import FusedSepConv, fused_quantized_apply
from emx_torch.serve.quantize import (Int8Conv, StoreConv, calibrate,
                                      quantize_convs, quantized_apply)

KW = dict(norm="none", space_to_depth=2, folded_head=16)


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).random((2, 64, 64)).astype(np.float32)
    model = FlaxDenoiser(dataclasses.replace(FlaxConfig.tiny(), **KW))
    variables = model.init(jax.random.key(1), jnp.asarray(x), train=False)
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(variables["params"], sep="/").items()}
    port = load_flax_params(Denoiser(dataclasses.replace(
        DenoiserConfig.tiny(), **KW), device="cpu"), flat).eval()
    return x, model, variables, port


def _close_to_grid(got, ref):
    # Same int8 grid and exact int32 sums; float32 stages between the
    # convs agree to rounding, but an input within that rounding of a
    # grid midpoint may take the neighbouring level: rare single-step
    # departures, so a tight mean and a loose max.
    err = np.abs(got - ref)
    assert err.mean() < 1e-4 and err.max() < 1e-2, (err.mean(), err.max())


@pytest.mark.parametrize("per_channel", [True, False])
def test_calibrate_matches_flax(setup, per_channel):
    x, model, variables, port = setup
    ref = flax_calibrate(model, variables, [jnp.asarray(x)],
                         per_channel=per_channel)
    got = calibrate(port, [torch.from_numpy(x)], per_channel=per_channel)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["mxu", "store"])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantized_apply_matches_flax(setup, mode, per_channel):
    x, model, variables, port = setup
    amax = flax_calibrate(model, variables, [jnp.asarray(x)],
                          per_channel=per_channel)
    ref = np.asarray(flax_quantized(model, variables, amax, mode)(
        jnp.asarray(x)))
    got = quantized_apply(port, amax, mode)(torch.from_numpy(x)).numpy()
    _close_to_grid(got, ref)


def test_quantized_graph_swaps_the_right_convs(setup):
    """mxu: dense convs go int8, depthwise convs get the int8 round-trip,
    skipped convs stay float; the model itself is left untouched."""
    x, model, variables, port = setup
    amax = flax_calibrate(model, variables, [jnp.asarray(x)])
    graph = quantize_convs(port, amax, "mxu",
                           skip=("ConvBlock_0/Conv_0",))
    mods = dict(graph.named_modules())
    assert isinstance(mods["SepConvBlock_0.Conv_0"], StoreConv)
    assert isinstance(mods["SepConvBlock_0.Conv_1"], Int8Conv)
    assert type(mods["ConvBlock_0.Conv_0"]).__name__ == "Conv"
    assert type(port.SepConvBlock_0.Conv_1).__name__ == "Conv"
    with pytest.raises(NotImplementedError):
        quantize_convs(port, amax, "mxu2")


def test_fused_matches_flax(setup):
    """min_pixels=0: every stride-1, rate-1 SepConvBlock fuses, and
    bypasses quantization, in both packages."""
    x, model, variables, port = setup
    amax = flax_calibrate(model, variables, [jnp.asarray(x)])
    ref = np.asarray(flax_fused(model, variables, amax, "mxu",
                                min_pixels=0, rows=8, interpret=True)(
        jnp.asarray(x)))
    got = fused_quantized_apply(port, amax, "mxu", min_pixels=0, rows=8)(
        torch.from_numpy(x)).numpy()
    _close_to_grid(got, ref)


def test_fused_claims_only_qualifying_blocks(setup, monkeypatch):
    x, model, variables, port = setup
    amax = flax_calibrate(model, variables, [jnp.asarray(x)])
    calls = []

    def spy(x, *args, rows):
        calls.append((tuple(x.shape), rows))
        return fused_sepconv(x, *args, rows=rows)

    monkeypatch.setattr("emx_torch.serve.fused.fused_sepconv", spy)
    fused_quantized_apply(port, amax, "mxu", min_pixels=32 * 32, rows=12)(
        torch.from_numpy(x))
    # s2d 2 on 64x64: the 32x32 stages qualify (encoder block 0, the
    # refinement, the folded head); rows=12 -> the largest divisor of
    # 32 that is <= 12 is 8. Strided and smaller blocks do not.
    assert len(calls) == 6
    assert all(s[1:3] == (32, 32) and r == 8 for s, r in calls)
    n_fusable = sum(isinstance(m, FusedSepConv) for m in quantize_convs(
        port, amax, "mxu").modules())
    assert n_fusable == 0


@pytest.mark.parametrize("fused", [False, True], ids=["mxu", "fused"])
def test_bf16_graphs_close_to_flax(fused):
    """The flagship's setting: bf16 activations, int8 mxu, s2d 4 with a
    folded head. bf16 rounds at other places in the two frameworks
    (conv accumulation, bias adds, resize), and an activation moved by a
    bf16 step can cross an int8 grid midpoint, so the graphs agree to a
    few bf16 steps of [0, 1] outputs: mean < 5e-3, max < 5e-2."""
    kw = dict(norm="none", space_to_depth=4, folded_head=16)
    x = np.random.default_rng(0).random((2, 128, 128)).astype(np.float32)
    model = FlaxDenoiser(dataclasses.replace(FlaxConfig.tiny(),
                                             dtype=jnp.bfloat16, **kw))
    variables = model.init(jax.random.key(1), jnp.asarray(x), train=False)
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(variables["params"], sep="/").items()}
    port = load_flax_params(Denoiser(dataclasses.replace(
        DenoiserConfig.tiny(), dtype=torch.bfloat16, **kw), device="cpu"),
        flat).eval()
    amax = flax_calibrate(model, variables, [jnp.asarray(x)])
    if fused:
        ref_fn = flax_fused(model, variables, amax, "mxu", min_pixels=0,
                            rows=8, interpret=True)
        got = fused_quantized_apply(port, amax, "mxu", min_pixels=0, rows=8)(
            torch.from_numpy(x))
    else:
        ref_fn = flax_quantized(model, variables, amax, "mxu")
        got = quantized_apply(port, amax, "mxu")(torch.from_numpy(x))
    ref = np.asarray(jax.jit(ref_fn)(jnp.asarray(x)), np.float32)
    err = np.abs(got.float().numpy() - ref)
    assert err.mean() < 5e-3 and err.max() < 5e-2, (err.mean(), err.max())

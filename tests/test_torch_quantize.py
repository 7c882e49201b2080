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
from emx.serve.fused import dense_quantized_apply as flax_dense
from emx.serve.fused import fused_quantized_apply as flax_fused
from emx.serve.quantize import calibrate as flax_calibrate
from emx.serve.quantize import quantized_apply as flax_quantized
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.ops.sepconv_kernel import fused_sepconv
from emx_torch.serve.convert import load_flax_params
from emx_torch.serve.fused import (DenseSepConv, FusedSepConv,
                                   dense_quantized_apply,
                                   fused_quantized_apply)
from emx_torch.serve.quantize import (Int8Conv, Int8DepthwiseConv, StoreConv,
                                      calibrate, quantize_convs,
                                      quantized_apply)

KW = dict(norm="none", space_to_depth=2, folded_head=16)
BF16_STEP = 2.0 ** -8   # one bf16 step of a [0, 1] output below 1.0


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
    mods2 = dict(quantize_convs(port, amax, "mxu2").named_modules())
    assert isinstance(mods2["SepConvBlock_0.Conv_0"], Int8DepthwiseConv)
    assert isinstance(mods2["SepConvBlock_0.Conv_1"], Int8Conv)
    with pytest.raises(ValueError, match="int4"):
        quantize_convs(port, amax, "int4")


@pytest.mark.parametrize("per_channel", [True, False])
def test_mxu2_matches_flax(setup, per_channel):
    """int8 depthwise convs: the same integer sums (exact in float32 on
    the port's side), so within one bf16 step of emx's output."""
    x, model, variables, port = setup
    amax = flax_calibrate(model, variables, [jnp.asarray(x)],
                          per_channel=per_channel)
    ref = np.asarray(flax_quantized(model, variables, amax, "mxu2")(
        jnp.asarray(x)))
    got = quantized_apply(port, amax, "mxu2")(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= BF16_STEP


@pytest.mark.parametrize("per_channel", [True, False])
def test_quantile_calibration_matches_flax(setup, per_channel):
    x, model, variables, port = setup
    ref = flax_calibrate(model, variables, [jnp.asarray(x)],
                         per_channel=per_channel, quantile=0.99)
    got = calibrate(port, [torch.from_numpy(x)], per_channel=per_channel,
                    quantile=0.99)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("capture", [
    "SepConvBlock_0/Conv_1", ("SepConvBlock_0/Conv_1", "ConvBlock_0/Conv_0")],
    ids=["one", "tuple"])
def test_capture_matches_flax(setup, capture):
    """The float input of the named convs beside the output, in order;
    a captured conv is still quantized."""
    x, model, variables, port = setup
    amax = flax_calibrate(model, variables, [jnp.asarray(x)])
    ref_out, ref_cap = flax_quantized(model, variables, amax, "mxu",
                                      capture=capture)(jnp.asarray(x))
    out, cap = quantized_apply(port, amax, "mxu", capture=capture)(
        torch.from_numpy(x))
    if isinstance(capture, str):
        ref_cap, cap = (ref_cap,), (cap,)
    assert len(cap) == len(ref_cap)
    for a, b in zip(cap, ref_cap):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    _close_to_grid(out.numpy(), np.asarray(ref_out))
    plain = quantized_apply(port, amax, "mxu")(torch.from_numpy(x))
    assert torch.equal(out, plain)


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "float"])
def test_dense_matches_flax(setup, quantized):
    """Each qualifying block's pair folded into one dense 3x3 conv:
    within one bf16 step of emx's output."""
    x, model, variables, port = setup
    amax = flax_calibrate(model, variables, [jnp.asarray(x)])
    ref = np.asarray(flax_dense(model, variables, amax, "mxu", min_pixels=0,
                                quantized=quantized)(jnp.asarray(x)))
    got = dense_quantized_apply(port, amax, "mxu", min_pixels=0,
                                quantized=quantized)(torch.from_numpy(x))
    assert np.abs(got.numpy() - ref).max() <= BF16_STEP
    graph_types = {type(m) for m in quantize_convs(port, amax, "mxu")
                   .modules()}
    assert DenseSepConv not in graph_types   # the model is left alone


def test_dense_skip_of_conv_1_matches_emx(setup):
    """emx decides a folded pair's int8 on its Conv_0 alone
    (emx/serve/fused.py:159), and so does the port: a skip naming only a
    block's Conv_1 leaves the pair int8, within one bf16 step of emx's
    output; a skip naming its Conv_0 runs it in float in both."""
    x, model, variables, port = setup
    amax = flax_calibrate(model, variables, [jnp.asarray(x)])
    xj, xt = jnp.asarray(x), torch.from_numpy(x)

    def emx_out(skip):
        return np.asarray(flax_dense(model, variables, amax, "mxu",
                                     skip=skip, min_pixels=0)(xj))

    def port_out(skip):
        return dense_quantized_apply(port, amax, "mxu", skip=skip,
                                     min_pixels=0)(xt).numpy()

    for skip in (("SepConvBlock_0/Conv_1",), ("SepConvBlock_0/Conv_0",)):
        assert np.abs(port_out(skip) - emx_out(skip)).max() <= BF16_STEP
    np.testing.assert_array_equal(port_out(("SepConvBlock_0/Conv_1",)),
                                  port_out(()))


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


@pytest.mark.parametrize("graph", ["mxu", "fused", "mxu2", "dense_int8"],
                         ids=["mxu", "fused", "mxu2", "dense_int8"])
def test_bf16_graphs_close_to_flax(graph):
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
    if graph == "fused":
        ref_fn = flax_fused(model, variables, amax, "mxu", min_pixels=0,
                            rows=8, interpret=True)
        got = fused_quantized_apply(port, amax, "mxu", min_pixels=0, rows=8)(
            torch.from_numpy(x))
    elif graph == "dense_int8":
        ref_fn = flax_dense(model, variables, amax, "mxu", min_pixels=0)
        got = dense_quantized_apply(port, amax, "mxu", min_pixels=0)(
            torch.from_numpy(x))
    else:
        ref_fn = flax_quantized(model, variables, amax, graph)
        got = quantized_apply(port, amax, graph)(torch.from_numpy(x))
    ref = np.asarray(jax.jit(ref_fn)(jnp.asarray(x)), np.float32)
    err = np.abs(got.float().numpy() - ref)
    assert err.mean() < 5e-3 and err.max() < 5e-2, (err.mean(), err.max())

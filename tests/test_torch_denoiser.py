"""The port's Denoiser against emx's on the same flax-initialised
parameters, the golden fixture, and the flagship bundle's conversion."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from emx.data.pipeline import synthetic_micrographs
from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.serve.artifact import read_artifact
from emx_torch.serve.convert import load_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "docs", "runs", "flagship", "artifact_int8.npz")


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _pair(seed=1, x=None, **kw):
    """(flax output, port output) for one tiny config on one input."""
    fcfg = dataclasses.replace(FlaxConfig.tiny(), **kw)
    tkw = dict(kw)
    if "dtype" in tkw:
        tkw["dtype"] = {jnp.bfloat16: torch.bfloat16}[tkw["dtype"]]
    tcfg = dataclasses.replace(DenoiserConfig.tiny(), **tkw)
    if x is None:
        x = np.random.default_rng(0).random((2, 64, 64)).astype(np.float32)
    model = FlaxDenoiser(fcfg)
    variables = model.init(jax.random.key(seed), jnp.asarray(x), train=False)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False),
                     np.float32)
    port = load_flax_params(Denoiser(tcfg, device="cpu"),
                            _flat(variables["params"]),
                            _flat(variables.get("batch_stats", {})))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).float().numpy()
    return ref, got


# Tolerances: float32 sums run in other orders (1e-5); flax's GroupNorm
# takes the variance as E[x^2] - E[x]^2 in one pass, torch in two, which
# moves outputs by up to ~3e-4 on these tiny random features (1e-3).
CONFIGS = [
    (dict(norm="group"), 1e-3),
    (dict(norm="group", space_to_depth=4, folded_head=16), 1e-3),
    (dict(norm="none", space_to_depth=4, folded_head=16), 1e-5),
    (dict(norm="none", space_to_depth=2, folded_head=16), 1e-5),
    (dict(norm="batch", space_to_depth=2, folded_head=16), 1e-5),
    (dict(norm="group", upsample="resize_sep", aspp_separable=False), 1e-3),
]


@pytest.mark.parametrize("kw,tol", CONFIGS, ids=[str(c[0]) for c in CONFIGS])
def test_forward_matches_flax(kw, tol):
    ref, got = _pair(**kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def test_bf16_forward_close_to_flax():
    # bf16 rounds at other places in the two frameworks (conv
    # accumulation, bias adds, resize), so only closeness in the mean
    # and a bound of a few bf16 steps of [0, 1] outputs hold.
    ref, got = _pair(norm="none", space_to_depth=4, folded_head=16,
                     dtype=jnp.bfloat16)
    err = np.abs(got - ref)
    assert err.mean() < 2e-3 and err.max() < 5e-2, (err.mean(), err.max())


def test_reproduces_golden_fixture():
    """tests/golden/denoiser_fwd.npy, built as tests/test_golden.py
    builds it (flax-initialised params, key 7)."""
    x = synthetic_micrographs(1, 64, seed=123)
    kw = dict(features=(8, 12, 16, 24, 24), num_middle_blocks=1,
              aspp_filters=16, aspp_out=16, norm="group")
    _, got = _pair(seed=7, x=x, **kw)
    expect = np.load(os.path.join(ROOT, "tests", "golden", "denoiser_fwd.npy"))
    # The fixture's own test allows 2e-2 for conv autotuning; GroupNorm's
    # variance formula (see CONFIGS) bounds the port's departure.
    np.testing.assert_allclose(got, expect, atol=1e-3, rtol=0)


def test_flagship_bundle_converts_exactly():
    """All 264 arrays of the flagship bundle land in the full-width port,
    every shape fits, no key is unused and no parameter unfilled."""
    cfg, flat, quant = read_artifact(FLAGSHIP)
    assert len(flat) == 264
    assert cfg.space_to_depth == 4 and cfg.folded_head == 128
    assert cfg.dtype is torch.bfloat16 and cfg.norm == "none"
    model = load_flax_params(Denoiser(cfg, device="cpu"), flat)
    n_port = sum(1 for _ in model.parameters())
    assert n_port == 264
    k = flat["SepConvBlock_0/Conv_0/kernel"]             # (3, 3, 1, 16)
    w = model.SepConvBlock_0.Conv_0.weight.detach().numpy()  # (16, 1, 3, 3)
    np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))
    kt = flat["DeconvBlock_1/ConvTranspose_0/kernel"]    # (3, 3, I, O)
    wt = model.DeconvBlock_1.ConvTranspose_0.weight.detach().numpy()
    np.testing.assert_array_equal(wt, kt[::-1, ::-1].transpose(2, 3, 0, 1))
    convs = {m.path for m in model.modules()
             if type(m).__name__ == "Conv"}
    assert convs == set(quant["amax"]) and len(convs) == 130


def test_converter_raises_on_leftovers():
    cfg, flat, _ = read_artifact(FLAGSHIP)
    with pytest.raises(ValueError, match="unused"):
        load_flax_params(Denoiser(cfg, device="cpu"),
                         {**flat, "Extra_0/kernel": np.zeros(1)})
    missing = dict(flat)
    del missing["ConvBlock_8/Conv_0/bias"]
    with pytest.raises(KeyError, match="ConvBlock_8/Conv_0/bias"):
        load_flax_params(Denoiser(cfg, device="cpu"), missing)
    bad = {**flat, "ConvBlock_8/Conv_0/bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(Denoiser(cfg, device="cpu"), bad)


@pytest.mark.parametrize("head", ["full_res_head", "mid_res_head",
                                  "kernel_pred_head"])
def test_unported_heads_raise(head):
    """The heads that raised NotImplementedError until they were ported
    now build and run (their parity with flax is in
    tests/test_torch_heads.py); a norm the port does not know still
    raises."""
    from emx_torch.nn.init import init_parameters

    cfg = dataclasses.replace(DenoiserConfig.tiny(), space_to_depth=4,
                              **{head: 8})
    model = init_parameters(Denoiser(cfg, device="cpu"),
                            torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = model(torch.rand((2, 64, 64)))
    assert out.shape == (2, 64, 64) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="unknown norm"):
        Denoiser(dataclasses.replace(cfg, norm="layer"), device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        model = Denoiser(DenoiserConfig.tiny())
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Denoiser(DenoiserConfig.tiny())

"""Deployment half of the training slice on the CPU: BatchNorm folding
against emx's, the folded model against the BatchNorm model, bundles
saved by the port loaded by emx and the reverse, and warm-start pytrees
both ways. One jitted flax init and one jitted flax forward are shared
through module fixtures."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.serve.artifact import load_denoiser_artifact as flax_load_artifact
from emx.serve.artifact import load_pytree_like as flax_load_pytree
from emx.serve.artifact import save_denoiser_artifact as flax_save_artifact
from emx.serve.artifact import save_pytree_npz as flax_save_pytree
from emx.serve.optimize import fold_denoiser as flax_fold_denoiser
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.serve.artifact import (load_denoiser_artifact,
                                      load_pytree_like,
                                      save_denoiser_artifact,
                                      save_pytree_npz)
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.serve.optimize import fold_batchnorm, fold_denoiser

BN_KW = dict(norm="batch", space_to_depth=4, folded_head=16)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def bn_model():
    """A flagship-shaped tiny BatchNorm Denoiser (s2d 4, folded head) with
    trained-looking norms: random scales, biases and running statistics,
    so that the fold moves every conv."""
    cfg = dataclasses.replace(FlaxConfig.tiny(), **BN_KW)
    model = FlaxDenoiser(cfg)
    rng = np.random.default_rng(0)
    x = rng.random((2, 64, 64)).astype(np.float32)
    variables = jax.jit(lambda k, a: model.init(k, a, train=False))(
        jax.random.key(2), jnp.asarray(x))
    params = _flat(variables["params"])
    for k in params:
        if "/BatchNorm_0/" in k:
            params[k] = rng.normal(1.0 if k.endswith("scale") else 0.0, 0.2,
                                   params[k].shape).astype(np.float32)
    stats = {k: (rng.uniform(0.5, 2.0, v.shape) if k.endswith("var")
                 else rng.normal(0.0, 0.3, v.shape)).astype(np.float32)
             for k, v in _flat(variables["batch_stats"]).items()}
    return cfg, params, stats, x


@pytest.fixture(scope="module")
def folded(bn_model):
    """emx's fold of the model, and emx's forward of the folded model."""
    cfg, params, stats, x = bn_model
    fcfg, fvars = flax_fold_denoiser(cfg, {
        "params": unflatten_dict(params, sep="/"),
        "batch_stats": unflatten_dict(stats, sep="/")})
    fmodel = FlaxDenoiser(fcfg)
    out = jax.jit(lambda v, a: fmodel.apply(v, a, train=False))(
        fvars, jnp.asarray(x))
    return fcfg, _flat(fvars["params"]), np.asarray(out)


def _port_cfg(**kw):
    return dataclasses.replace(DenoiserConfig.tiny(), **{**BN_KW, **kw})


def test_fold_matches_emx(bn_model, folded):
    """Both fold in float64 and round to float32 once: 1e-6."""
    _, params, stats, _ = bn_model
    fcfg, ref, _ = folded
    cfg, got = fold_denoiser(_port_cfg(), params, stats)
    assert cfg.norm == "none" and fcfg.norm == "none"
    assert set(got) == set(ref)
    assert not any("Norm_" in k for k in got)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_folded_model_matches_batchnorm_model(bn_model):
    """The folded model in eval against the BatchNorm model in eval on
    the same input. float32: the fold moves roundings from the norm into
    the conv weights, 1e-5 on outputs in [0, 1]."""
    _, params, stats, x = bn_model
    bn = load_flax_params(Denoiser(_port_cfg(), device="cpu"), params, stats)
    cfg, fparams = fold_denoiser(bn.config, *to_flax_params(bn))
    plain = load_flax_params(Denoiser(cfg, device="cpu"), fparams)
    with torch.inference_mode():
        a = bn(torch.from_numpy(x)).numpy()
        b = plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert a.std() > 0.01   # the model computes something


def _port_forward(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


def test_port_bundle_loads_in_emx(bn_model, folded, tmp_path):
    """A bundle the port saves, with an int8 recipe, loads in emx's
    load_denoiser_artifact unchanged: the same config, parameters and
    quant JSON, and the port's forward of it equals emx's (float32,
    1e-5)."""
    _, params, stats, x = bn_model
    fcfg, _, ref_out = folded
    cfg, fparams = fold_denoiser(_port_cfg(), params, stats)
    amax = {"Conv_0": np.linspace(0.5, 2.0, 16).astype(np.float32),
            "ConvBlock_0/Conv_0": 3.0}
    path = str(tmp_path / "port.npz")
    save_denoiser_artifact(path, cfg, {"params": fparams},
                           quant={"mode": "mxu", "amax": amax, "note": "x"})
    lcfg, lvars, quant = flax_load_artifact(path, with_quant=True)
    assert lcfg == dataclasses.replace(fcfg, remat_middle=False)
    got = _flat(lvars["params"])
    assert set(got) == set(fparams)
    for k, v in fparams.items():
        np.testing.assert_array_equal(got[k], v)
    assert quant["mode"] == "mxu" and quant["note"] == "x"
    np.testing.assert_array_equal(quant["amax"]["Conv_0"], amax["Conv_0"])
    assert quant["amax"]["ConvBlock_0/Conv_0"] == 3.0
    _, model = load_denoiser_artifact(path, device="cpu")
    np.testing.assert_allclose(_port_forward(model, x), ref_out, atol=1e-5)


def test_emx_bundle_loads_in_port(folded, bn_model, tmp_path):
    fcfg, fparams, ref_out = folded
    x = bn_model[3]
    path = str(tmp_path / "emx.npz")
    flax_save_artifact(path, fcfg, {"params": unflatten_dict(fparams,
                                                             sep="/")})
    cfg, model = load_denoiser_artifact(path, device="cpu")
    assert cfg.norm == "none" and cfg.space_to_depth == 4
    np.testing.assert_allclose(_port_forward(model, x), ref_out, atol=1e-5)
    assert to_flax_params(model)[0].keys() == fparams.keys()


def test_unfolded_models_refused(bn_model, tmp_path):
    _, params, stats, _ = bn_model
    path = str(tmp_path / "refused.npz")
    with pytest.raises(ValueError, match="folded"):
        save_denoiser_artifact(path, _port_cfg(),
                               {"params": params, "batch_stats": stats})
    with pytest.raises(ValueError, match="folded"):
        save_denoiser_artifact(path, _port_cfg(), {"params": params})
    with pytest.raises(ValueError, match="quant"):
        save_denoiser_artifact(path, _port_cfg(norm="none"),
                               {"params": {}}, quant={"mode": "fp8"})
    with pytest.raises(ValueError, match="GroupNorm"):
        fold_denoiser(_port_cfg(norm="group"), params, stats)


def test_one_batchnorm_per_scope():
    p = {"B/Conv_0/kernel": np.ones((1, 1, 2, 2), np.float32),
         "B/Norm_0/BatchNorm_0/scale": np.ones(2, np.float32),
         "B/Norm_0/BatchNorm_0/bias": np.zeros(2, np.float32),
         "B/Norm_1/BatchNorm_0/scale": np.ones(2, np.float32),
         "B/Norm_1/BatchNorm_0/bias": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="one BatchNorm per module scope"):
        fold_batchnorm(p, {})


def test_fold_arithmetic():
    """k' = k g / sqrt(v + eps), b' = beta + (b - m) g / sqrt(v + eps),
    on the highest-numbered conv of the scope; a norm without running
    statistics stays."""
    k = np.arange(8, dtype=np.float32).reshape(1, 1, 4, 2)
    p = {"S/Conv_0/kernel": np.ones((3, 3, 1, 4), np.float32),
         "S/Conv_1/kernel": k, "S/Conv_1/bias": np.array([1.0, 2.0],
                                                          np.float32),
         "S/Norm_0/BatchNorm_0/scale": np.array([2.0, 0.5], np.float32),
         "S/Norm_0/BatchNorm_0/bias": np.array([0.1, 0.2], np.float32),
         "T/Conv_0/kernel": k,
         "T/Norm_0/BatchNorm_0/scale": np.ones(2, np.float32),
         "T/Norm_0/BatchNorm_0/bias": np.zeros(2, np.float32)}
    stats = {"S/Norm_0/BatchNorm_0/mean": np.array([0.5, -1.0], np.float32),
             "S/Norm_0/BatchNorm_0/var": np.array([3.999, 0.999],
                                                  np.float32)}
    out = fold_batchnorm(p, stats)
    s = np.array([2.0, 0.5]) / np.sqrt(np.array([3.999, 0.999]) + 1e-3)
    np.testing.assert_allclose(out["S/Conv_1/kernel"], k * s, rtol=1e-6)
    np.testing.assert_allclose(out["S/Conv_1/bias"],
                               [0.1 + 0.5 * s[0], 0.2 + 3.0 * s[1]],
                               rtol=1e-6)
    np.testing.assert_array_equal(out["S/Conv_0/kernel"], p["S/Conv_0/kernel"])
    assert "S/Norm_0/BatchNorm_0/scale" not in out
    assert "T/Norm_0/BatchNorm_0/scale" in out   # no statistics: kept


def test_pytree_npz_both_ways(bn_model, tmp_path):
    """Warm-start states cross between the frameworks: emx's file into a
    torch reference tree, and the port's file (with a bfloat16 leaf,
    widened to float32) into a flax one."""
    _, params, stats, _ = bn_model
    tree = {"params": unflatten_dict(params, sep="/"),
            "batch_stats": unflatten_dict(stats, sep="/")}
    emx_path = str(tmp_path / "emx_state.npz")
    flax_save_pytree(emx_path, tree, meta={"step": 7})
    ref = jax.tree_util.tree_map(lambda a: torch.zeros(a.shape), tree)
    got, meta = load_pytree_like(emx_path, ref)
    assert meta == {"step": 7}
    for k, v in _flat(tree).items():
        t = got
        for part in k.split("/"):
            t = t[part]
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), v)

    port_tree = {"w": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16),
                 "layers": [torch.ones(2), torch.zeros(3)]}
    port_path = str(tmp_path / "port_state.npz")
    save_pytree_npz(port_path, port_tree, meta={"note": "warm"})
    flax_ref = {"w": jnp.zeros((2, 3)), "layers": [jnp.zeros(2),
                                                   jnp.zeros(3)]}
    back, meta = flax_load_pytree(port_path, flax_ref)
    assert meta == {"note": "warm"}
    np.testing.assert_array_equal(np.asarray(back["w"]),
                                  np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(np.asarray(back["layers"][0]), np.ones(2))
    with pytest.raises(KeyError):
        load_pytree_like(port_path, {"missing": torch.zeros(1)})


def test_flax_params_round_trip():
    """to_flax_params inverts load_flax_params, transposed-conv flip
    included (the BatchNorm statistics come back too)."""
    rng = np.random.default_rng(3)
    model = Denoiser(_port_cfg(), device="cpu")
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.copy_(torch.from_numpy(rng.random(t.shape).astype(np.float32)))
    params, stats = to_flax_params(model)
    k = params["DeconvBlock_0/ConvTranspose_0/kernel"]
    w = model.DeconvBlock_0.ConvTranspose_0.weight.detach().numpy()
    np.testing.assert_array_equal(k[::-1, ::-1].transpose(2, 3, 0, 1), w)
    copy = load_flax_params(Denoiser(_port_cfg(), device="cpu"), params,
                            stats)
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              copy.state_dict().items()):
        assert torch.equal(a, b), n

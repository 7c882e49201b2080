"""The Denoiser's other heads, norm='instance', FoldedHeadTail and
tail_param_names against emx's, on tiny configs and the same
flax-initialised parameters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.nn.denoiser import FoldedHeadTail as FlaxTail
from emx.nn.denoiser import tail_param_names as flax_tail_names
from emx.serve.quantize import calibrate as flax_calibrate
from emx.serve.quantize import quantized_apply as flax_quantized
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.nn.denoiser import (FoldedHeadTail, _gaussian_blur_nhwc,
                                   tail_param_names)
from emx_torch.nn.init import init_parameters
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.serve.quantize import calibrate, quantized_apply


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _x(n=2, size=64, seed=0):
    return np.random.default_rng(seed).random((n, size, size)).astype(
        np.float32)


def _models(seed=1, **kw):
    """(flax model, its variables, the port's model with them)."""
    fcfg = dataclasses.replace(FlaxConfig.tiny(), **kw)
    tcfg = dataclasses.replace(DenoiserConfig.tiny(), **kw)
    model = FlaxDenoiser(fcfg)
    variables = model.init(jax.random.key(seed), jnp.asarray(_x()),
                           train=False)
    port = load_flax_params(Denoiser(tcfg, device="cpu"),
                            _flat(variables["params"]),
                            _flat(variables.get("batch_stats", {})))
    return model, variables, port.eval()


# Each head (and pairs of them) at float32 with no norm: the port's sums
# run in other orders than XLA's, 1e-5 on [0, 1] outputs.
HEADS = [
    dict(space_to_depth=4, mid_res_head=8),
    dict(space_to_depth=4, mid_res_head=8, mid_res_factor=4,
         mid_res_depth=1),
    dict(space_to_depth=4, kernel_pred_head=2),
    dict(space_to_depth=4, kernel_pred_head=3, folded_head=16),
    dict(space_to_depth=2, full_res_head=8),
    dict(space_to_depth=4, full_res_head=8, mid_res_head=8),
    dict(space_to_depth=4, full_res_head=4, kernel_pred_head=1),
    dict(space_to_depth=1, full_res_head=4, mid_res_head=8),
]


@pytest.mark.parametrize("kw", HEADS, ids=[str(k) for k in HEADS])
def test_head_forward_matches_flax(kw):
    """load_flax_params maps every flax array to exactly one port tensor
    (it raises otherwise), and the forwards agree."""
    model, variables, port = _models(norm="none", **kw)
    x = _x(seed=3)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(norm="instance"),
    dict(norm="instance", space_to_depth=4, folded_head=16),
    dict(norm="instance", space_to_depth=4, kernel_pred_head=2),
])
def test_instance_norm_matches_flax(kw):
    """flax GroupNorm(group_size=1), eps 1e-6: its one-pass variance
    against torch's two-pass one moves outputs by up to ~3e-4 on tiny
    random features (the GroupNorm tolerance, 1e-3)."""
    model, variables, port = _models(**kw)
    x = _x(seed=4)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert any(k.endswith("GroupNorm_0/scale")
               for k in _flat(variables["params"]))


def test_kernel_pred_head_bf16_close_to_flax():
    """bf16 rounds the blurs, the softmax inputs and the convs at other
    places in the two frameworks: a few bf16 steps at most."""
    model, variables, port = _models(norm="none", space_to_depth=4,
                                     kernel_pred_head=3,
                                     dtype=jnp.bfloat16)
    port_cfg = dataclasses.replace(port.config, dtype=torch.bfloat16)
    port = load_flax_params(Denoiser(port_cfg, device="cpu"),
                            _flat(variables["params"])).eval()
    x = _x(seed=5)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False),
                     np.float32)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).float().numpy()
    err = np.abs(got - ref)
    assert err.mean() < 2e-3 and err.max() < 5e-2, (err.mean(), err.max())


@pytest.mark.parametrize("sigma", [0.3, 1.0, 2.0, 4.0])
def test_gaussian_blur_basis_matches_flax(sigma):
    from emx.nn.denoiser import _gaussian_blur_nhwc as flax_blur

    x = _x(n=2, size=24)[..., None]
    ref = np.asarray(flax_blur(jnp.asarray(x), sigma))
    got = _gaussian_blur_nhwc(torch.from_numpy(x), sigma).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [HEADS[0], HEADS[2], HEADS[4],
                                dict(norm="instance", space_to_depth=4,
                                     folded_head=16)])
def test_init_covers_every_head_parameter(kw):
    """init_parameters fills every tensor of the new heads with flax's
    distributions (kernels non-zero, biases zero), and the names and
    shapes are flax's."""
    model, variables, _ = _models(**{"norm": "none", **kw})
    port = Denoiser(dataclasses.replace(DenoiserConfig.tiny(),
                                        **{"norm": "none", **kw}),
                    device="cpu")
    init_parameters(port, torch.Generator().manual_seed(0))
    params, _ = to_flax_params(port)
    ref = _flat(variables["params"])
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in ref.items()}
    assert all(np.any(v != 0) for k, v in params.items()
               if k.endswith("kernel"))
    assert all(not np.any(v) for k, v in params.items()
               if k.endswith("/bias") and "GroupNorm" not in k)


def test_one_value_groups_raise_where_flax_returns_the_bias():
    """A fault of the port's GroupNorm (ROADMAP Queue 3): flax normalises
    a group that holds one value to 0 (its variance is 0) and returns
    the bias; `F.group_norm` refuses a batch of one whose groups each
    hold one value, as an instance norm at a 1x1 map gives it. A batch
    of two is served."""
    import flax.linen as fnn
    from emx_torch.nn.blocks import GroupNorm

    x = np.random.default_rng(0).random((1, 1, 1, 8)).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=None, group_size=1)
    variables = gn.init(jax.random.key(0), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(gn.apply(variables,
                                                   jnp.asarray(x))),
                               0.0, atol=1e-6)
    port = GroupNorm(8, 8, torch.float32)
    with pytest.raises(ValueError, match="more than 1 value"):
        port(torch.from_numpy(x))
    two = port(torch.from_numpy(np.repeat(x, 2, axis=0)))
    assert two.shape == (2, 1, 1, 8)


def test_head_rejects_unknown_norm():
    with pytest.raises(ValueError, match="unknown norm"):
        Denoiser(dataclasses.replace(DenoiserConfig.tiny(), norm="layer"),
                 device="cpu")


# FoldedHeadTail: the flagship-shaped tiny config (s2d 4, folded head).
TAIL_KW = dict(norm="none", space_to_depth=4, folded_head=16)
SCOPES = ("head", "refine", "decoder", "decoder2")


@pytest.fixture(scope="module")
def tail_setup():
    model, variables, port = _models(**TAIL_KW)
    x = _x(seed=2)
    amax, order = flax_calibrate(model, variables, [jnp.asarray(x)],
                                 return_order=True)
    p_amax, p_order = calibrate(port, [torch.from_numpy(x)],
                                return_order=True)
    return model, variables, port, x, order, p_order


def test_calibrate_order_matches_flax(tail_setup):
    """calibrate(return_order=True) returns the convs in the order the
    forward runs them, as emx's does."""
    *_, order, p_order = tail_setup
    assert p_order == order and len(order) == len(set(order))


@pytest.mark.parametrize("scope", SCOPES)
def test_tail_param_names_match_flax(tail_setup, scope):
    *_, order, p_order = tail_setup
    got = tail_param_names(p_order, 2, scope)
    assert got == flax_tail_names(order, 2, scope)


def test_tail_param_names_refuses_a_short_order():
    with pytest.raises(ValueError, match="not a head tail"):
        tail_param_names(["SepConvBlock_0/Conv_0", "ConvBlock_0/Conv_0"],
                         2, "head")


def _captures(order, mapping, scope):
    inv = {v: k for k, v in mapping.items()}
    if scope == "decoder2":
        return tuple(next(p for p in order if p.split("/")[0] == inv[n])
                     for n in ("SepConvBlock_0", "SepConvBlock_2"))
    return next(p for p in order if p.split("/")[0] in mapping)


def _tail_inputs(captured, x, scope, f2):
    if scope == "decoder2":
        cat1, cat2 = captured
        return (cat1, cat2[..., f2:], x)
    return captured if scope == "head" else (captured, x)


def _port_tail(port, mapping, scope):
    params, _ = to_flax_params(port)
    tail_params = {}
    for old, new in mapping.items():
        for k, v in params.items():
            if k.split("/")[0] == old:
                tail_params[new + k[len(old):]] = v
    return load_flax_params(FoldedHeadTail(port.config, scope,
                                           device="cpu"), tail_params)


@pytest.mark.parametrize("scope", SCOPES)
def test_tail_replicates_the_full_model(tail_setup, scope):
    """The port's tail, with parameters mapped from the port's full
    model, gives the full model's output from the captured features
    (emx's tests/test_quantize.py:158-255 recipe)."""
    _, _, port, x, _, order = tail_setup
    mapping = tail_param_names(order, 2, scope)
    caps = _captures(order, mapping, scope)
    full, captured = quantized_apply(port, {}, capture=caps)(
        torch.from_numpy(x))
    tail = _port_tail(port, mapping, scope)
    with torch.inference_mode():
        out = tail(_tail_inputs(captured, torch.from_numpy(x), scope,
                                port.config.features[2]))
    assert out.dtype == torch.float32 and out.shape == full.shape
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("scope", SCOPES)
def test_tail_matches_flax_tail(tail_setup, scope):
    """The port's tail against emx's FoldedHeadTail on the same captured
    features (emx's capture) and parameters."""
    model, variables, port, x, order, _ = tail_setup
    mapping = flax_tail_names(order, 2, scope)
    caps = _captures(order, mapping, scope)
    _, captured = flax_quantized(model, variables, {}, capture=caps)(
        jnp.asarray(x))
    f2 = model.config.features[2]
    flax_tail = FlaxTail(model.config, tail_scope=scope)
    ref = np.asarray(flax_tail.apply(
        {"params": {new: variables["params"][old]
                    for old, new in mapping.items()}},
        _tail_inputs(captured, jnp.asarray(x), scope, f2)))
    tail = _port_tail(port, mapping, scope)
    t_in = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  _tail_inputs(captured, x, scope, f2))
    with torch.inference_mode():
        got = tail(t_in).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_tail_refuses_other_heads():
    cfg = dataclasses.replace(DenoiserConfig.tiny(), folded_head=16,
                              kernel_pred_head=2, space_to_depth=4)
    with pytest.raises(ValueError, match="folded_head and no other"):
        FoldedHeadTail(cfg, device="cpu")
    with pytest.raises(ValueError, match="tail_scope"):
        FoldedHeadTail(dataclasses.replace(cfg, kernel_pred_head=0),
                       "encoder", device="cpu")

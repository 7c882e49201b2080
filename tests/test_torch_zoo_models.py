"""The model zoo's forwards (emx_torch/nn/{autoencoder,latent,kernels,
fractal,profiles}.py) against emx's on the CPU: emx's parameter trees
(from jax.eval_shape of emx's init) at random values drawn by numpy
(tests/torch_zoo_helpers.py), carried across by load_flax_params; the
same numpy inputs; eval mode unless said.

Tolerances: float32 forwards within 1e-4 (the tiny models' sums in
other orders), the Xception autoencoder's rtol 1e-3 (~30 layers of
GroupNorm amplify the order of summation: 7 of 8192 pixels pass 1e-4,
by 1.4e-4); the bf16 XceptionAutoencoder, in mean, within 2x of flax's
bf16 distance from the float32 output on the same parameters: two
roundings of one function, neither the reference (seen: 1.6x on this
file's config, 0.0103 against 0.0065; 0.65x on XceptionAEConfig.tiny(),
0.0178 against 0.0273);
the latent encoder's dropout with emx's keep mask (recovered from emx's
train-mode latent) within 1e-5; KernelBank's two Adam steps of every
(depth, width) within 1e-6 of emx's bank on the same noisy/clean
batches."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emx.nn as E
from emx.nn import fractal as emx_fractal
from emx.nn import profiles as emx_profiles
from emx.nn.kernels import num_unique as emx_num_unique
from emx.nn.kernels import symmetry_index_map as emx_index_map
from emx_torch.nn import fractal, kernels, profiles
from emx_torch.nn.autoencoder import (EmbedderConfig, SmallAEConfig,
                                      SmallAutoencoder, UnsupervisedEmbedder,
                                      XceptionAEConfig, XceptionAutoencoder,
                                      embedder_metric_loss)
from emx_torch.nn.latent import LatentAEConfig, LatentAutoencoder
from emx_torch.serve.convert import load_flax_params
from torch_zoo_helpers import (EMBEDDER, XCEPTION, as_emx, emx_variables, flat,
                               ref_jit)

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return flat(tree)


def _pair(emx_model, port_model, x, seed=0, **init_kw):
    """(emx's variables at random values, the port model loaded from
    them)."""
    v = emx_variables(emx_model, jnp.asarray(x), seed=seed, **init_kw)
    load_flax_params(port_model, v["params"], v.get("batch_stats"))
    return as_emx(v), port_model


def _apply(model, v, x, **kw):
    return np.asarray(ref_jit(lambda v, x: model.apply(v, x, **kw))(
        v, jnp.asarray(x)))


def _imgs(n, size, seed=0):
    return np.random.default_rng(seed).random((n, size, size)).astype(
        np.float32)


def test_small_autoencoder_matches_emx():
    cfg = dict(features=(8, 8, 16), bottleneck=8)
    x = _imgs(2, 32)
    v, port = _pair(E.SmallAutoencoder(E.SmallAEConfig(**cfg)),
                    SmallAutoencoder(SmallAEConfig(**cfg), device=CPU), x,
                    train=False)
    model = E.SmallAutoencoder(E.SmallAEConfig(**cfg))
    ref = _apply(model, v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        code = port.encode(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    # encode: emx's captured intermediates hold the bottleneck block's.
    inters = ref_jit(model.encode)(v, jnp.asarray(x))
    np.testing.assert_allclose(
        code.numpy(), np.asarray(inters["SepConvBlock_3"]["__call__"][0]),
        atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xception_autoencoder_matches_emx(dtype):
    fcfg = E.XceptionAEConfig(**XCEPTION, dtype=getattr(jnp, dtype))
    pcfg = XceptionAEConfig(**XCEPTION, dtype=getattr(torch, dtype))
    x = _imgs(2, 32, 1)
    # Parameters at seed 1: at seed 0 the output sits at its clip (0) on
    # 97% of the pixels.
    v, port = _pair(E.XceptionAutoencoder(fcfg),
                    XceptionAutoencoder(pcfg, device=CPU), x, seed=1,
                    train=False)
    ref = _apply(E.XceptionAutoencoder(fcfg), v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert 0.05 < np.mean((ref > 0) & (ref < 1))   # not all at a clip
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
        return
    # bf16: as close to flax's float32 output as flax's bf16 output is
    # (two independent roundings of one function leave each other by ~1.4x
    # what each leaves the exact one).
    ref32 = _apply(E.XceptionAutoencoder(dataclasses.replace(
        fcfg, dtype=jnp.float32)), v, x)
    err, own = np.abs(got - ref32).mean(), np.abs(ref - ref32).mean()
    print(f"bf16 against float32: port {err:.4f}, flax {own:.4f}, port "
          f"against flax {np.abs(got - ref).mean():.4f}")
    assert err <= 2.0 * own, (err, own)


def test_embedder_and_metric_loss_match_emx():
    x = _imgs(4, 32, 2)
    v, port = _pair(E.UnsupervisedEmbedder(E.EmbedderConfig(**EMBEDDER)),
                    UnsupervisedEmbedder(EmbedderConfig(**EMBEDDER),
                                         device=CPU), x, train=False)
    model = E.UnsupervisedEmbedder(E.EmbedderConfig(**EMBEDDER))
    for features in (False, True):
        ref = _apply(model, v, x, features=features)
        with torch.no_grad():
            got = port(torch.from_numpy(x), features=features).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    # The loss and its gradient: n (n - 2) off-pair entries, an even
    # count, so the median is the mean of the two middle ones.
    for n in (8,):
        e = np.random.default_rng(n).standard_normal((n, 5)).astype(
            np.float32)
        ref, gref = ref_jit(jax.value_and_grad(E.embedder_metric_loss))(
            jnp.asarray(e))
        t = torch.from_numpy(e).requires_grad_(True)
        got = embedder_metric_loss(t)
        got.backward()
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gref),
                                   atol=1e-6)


def test_latent_autoencoder_and_its_dropout_match_emx():
    cfg = E.LatentAEConfig.tiny()
    model = E.LatentAutoencoder(cfg)
    x = _imgs(3, 32, 3)
    v, port = _pair(model, LatentAutoencoder(LatentAEConfig.tiny(),
                                             device=CPU), x, train=False)
    ref = _apply(model, v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # Dropout: emx's keep mask from its train-mode latent.
    rngs = {"dropout": jax.random.key(5)}
    z_eval = _apply(model, v, x, method=E.LatentAutoencoder.encode)
    z_train = _apply(model, v, x, train=True, rngs=rngs,
                     method=E.LatentAutoencoder.encode)
    keep = np.asarray(z_train) != 0
    assert 0 < keep.mean() < 1
    full = _apply(model, v, x, train=True, rngs=rngs)
    with torch.no_grad():
        zt = port.encode(torch.from_numpy(x), True,
                         dropout_keep=torch.from_numpy(keep))
        out = port(torch.from_numpy(x), train=True,
                   dropout_keep=torch.from_numpy(keep)).numpy()
    np.testing.assert_allclose(zt.numpy(), np.asarray(z_train), atol=1e-5)
    np.testing.assert_allclose(out, full, atol=1e-4)
    np.testing.assert_allclose(np.where(keep, np.asarray(z_eval) / 0.75, 0),
                               np.asarray(z_train), atol=1e-6)


def test_fractal_and_profiles_match_emx():
    x = _imgs(2, 16, 4)
    fcfg = emx_fractal.FractalConfig(features=8, turns=3)
    v, port = _pair(emx_fractal.RecursiveFractalConv(fcfg),
                    fractal.RecursiveFractalConv(fractal.FractalConfig(
                        features=8, turns=3), device=CPU), x, train=False)
    ref = _apply(emx_fractal.RecursiveFractalConv(fcfg), v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)

    feats = np.random.default_rng(5).random((3, 40)).astype(np.float32)
    pcfg = emx_profiles.ProfileMLPConfig(hidden=(16, 8))
    v, port = _pair(emx_profiles.ProfileMLP(pcfg), profiles.ProfileMLP(
        profiles.ProfileMLPConfig(hidden=(16, 8)), device=CPU), feats)
    ref = _apply(emx_profiles.ProfileMLP(pcfg), v, feats)
    with torch.no_grad():
        got = port(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # The statistics vector and the equaliser.
    from emx.physics.stats import image_stats as emx_stats
    from emx_torch.physics.stats import image_stats

    img = _imgs(1, 32, 6)[0]
    ref = np.asarray(emx_profiles.stats_to_feature_vector(
        ref_jit(emx_stats)(jnp.asarray(img))))
    got = profiles.stats_to_feature_vector(
        image_stats(torch.from_numpy(img))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    mat = np.random.default_rng(7).gamma(2.0, size=(50, 3))
    np.testing.assert_allclose(
        profiles.FeatureEqualizer(mat, 20)(mat[:5]),
        emx_profiles.FeatureEqualizer(mat, 20)(mat[:5]), rtol=1e-6)


def test_symmetric_kernels_match_emx():
    for size in (3, 5, 7):
        np.testing.assert_array_equal(kernels.symmetry_index_map(size),
                                      emx_index_map(size))
        assert kernels.num_unique(size) == emx_num_unique(size)
    with pytest.raises(ValueError):
        kernels.symmetry_index_map(4)
    x = _imgs(2, 24, 8)
    v, port = _pair(E.KernelStack(size=5, depth=3),
                    kernels.KernelStack(size=5, depth=3), x)
    ref = _apply(E.KernelStack(size=5, depth=3), v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_kernel_bank_two_steps_match_emx():
    """Two steps of every (depth, width): the bank starts where emx's
    does (no draw) and moves as emx's nine Adams do."""
    bank_e = E.KernelBank()
    rng = np.random.default_rng(9)
    clean = rng.random((2, 4, 24, 24)).astype(np.float32)
    noisy = (clean + 0.2 * rng.standard_normal(clean.shape)).astype(
        np.float32)
    # emx's bank state: its initial values are constants (1 / k^2, 0).
    params = [{"params": {f"SymmetricKernel_{i}": {
        "unique": jnp.asarray(np.full((emx_num_unique(w),), 1.0 / (w * w),
                                      np.float32)),
        "bias": jnp.asarray(np.zeros((1,), np.float32))} for i in range(d)}}
        for d, w, _ in bank_e.models]
    one = jax.jit(bank_e.models[4][2].init)(jax.random.key(0),
                                            jnp.asarray(noisy[0]))
    for k, v in _flat(one).items():
        np.testing.assert_array_equal(v, _flat(params[4])[k])
    state = {"params": params, "opt": ref_jit(
        lambda ps: [bank_e.opt.init(p) for p in ps])(params)}
    step = bank_e.make_step()
    bank = kernels.KernelBank(device=CPU)
    pstate = bank.init()
    for m, p in zip(pstate["models"], state["params"]):
        got = {k: v.detach().numpy() for k, v in m.named_parameters()}
        for k, ref in _flat(p["params"]).items():
            np.testing.assert_array_equal(got[k.replace("/", ".")], ref)
    pstep = bank.make_step()
    for i in range(2):
        state, losses = step(state, jnp.asarray(noisy[i]),
                             jnp.asarray(clean[i]))
        pstate, plosses = pstep(pstate, torch.from_numpy(noisy[i]),
                                torch.from_numpy(clean[i]))
        np.testing.assert_allclose(plosses.numpy(), np.asarray(losses),
                                   rtol=1e-5)
    assert bank.labels() == bank_e.labels()
    for m, p in zip(pstate["models"], state["params"]):
        got = {k: v.detach().numpy() for k, v in m.named_parameters()}
        for k, ref in _flat(p["params"]).items():
            np.testing.assert_allclose(got[k.replace("/", ".")], ref,
                                       atol=1e-6)


def test_sepconv_activation_and_what_k1_fuses():
    """SepConvBlock(activation=) computes emx's leaky-relu block; K1's
    wiring (emx_torch/serve/fused.py) still takes only relu6 blocks with
    norm 'none' at stride 1."""
    from emx.nn.blocks import SepConvBlock as FlaxSep
    from emx_torch.nn.blocks import SepConvBlock, leaky_relu, relu6
    from emx_torch.serve.fused import _fusable

    x = np.random.default_rng(10).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    act = lambda t: jax.nn.leaky_relu(t, 0.2)  # noqa: E731
    v, port = _pair(FlaxSep(6, norm="none", activation=act),
                    SepConvBlock(4, 6, norm="none", activation=leaky_relu),
                    x)
    ref = _apply(FlaxSep(6, norm="none", activation=act), v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert (ref < 0).any()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert not _fusable(port)
    assert _fusable(SepConvBlock(4, 6, norm="none"))
    assert SepConvBlock(4, 6).activation is relu6

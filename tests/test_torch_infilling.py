"""The port's infilling examples and GAN nets (emx_torch/data/degrade.py,
emx_torch/nn/infilling.py, the gan_state converter in
emx_torch/serve/artifact.py) against emx's on the CPU, on the same numpy
inputs and emx's flax-initialised parameters.

Tolerances: masks, partial scans, crops and the D4 examples exact; the
antialiased resize 1e-6; forward passes of InfillingConfig.tiny() in
float32: the discriminator 1e-4 (flax's GroupNorm takes a one-pass
variance, the port's F.group_norm two passes), the generator 5e-4 (mean
1e-5): its last one-channel instance norm divides by a small spread, so
the reductions' order (it moves with the thread count) shifts a pixel by
up to ~1e-4. In bfloat16 the discriminator within 3e-2; the
generator's tanh output within 0.1 (mean 0.02) of emx's bf16 output:
its final one-channel instance norm divides by a small spread, and there
emx's own bf16 output leaves its float32 one by 0.87 at most (mean
0.069), so rounding order alone moves single pixels by a few bf16
steps. The converter round trip is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from emx.data import degrade as flax_degrade
from emx.nn.infilling import InfillingConfig as FlaxConfig
from emx.nn.infilling import InfillingGenerator as FlaxGenerator
from emx.nn.infilling import MultiscaleDiscriminator as FlaxDiscriminator
from emx.nn.infilling import multiscale_crops as flax_crops
from emx.serve.artifact import load_pytree_like as flax_load_pytree
from emx.serve.artifact import save_pytree_npz as flax_save_pytree
from emx_torch.data.degrade import (apply_partial_scan, bernoulli_mask,
                                    box_downsample, fixed_scan_mask,
                                    infilling_example, norm_neg1to1,
                                    occlude)
from emx_torch.data.pipeline import synthetic_micrographs
from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                    MultiscaleDiscriminator,
                                    multiscale_crops, resize_linear)
from emx_torch.serve.artifact import load_gan_state, save_gan_state
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.train.gan import GANConfig, GANTrainer

SIZE = 32
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("shape,coverage", [((512, 512), 1 / 64),
                                            ((512, 512), 1 / 100),
                                            ((64, 48), 1 / 16)])
def test_fixed_scan_mask_bit_exact(shape, coverage):
    got = fixed_scan_mask(shape, coverage)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(flax_degrade.fixed_scan_mask(shape,
                                                             coverage)))


def test_bernoulli_mask_coverage():
    gen = torch.Generator().manual_seed(0)
    m = bernoulli_mask(gen, (256, 256), 1 / 64)
    assert m.dtype == torch.bool
    assert float(m.float().mean()) == pytest.approx(1 / 64, rel=0.1)


def test_norm_and_partial_scan_match_emx():
    x = synthetic_micrographs(3, SIZE, seed=1) * 7.0 - 2.0
    x[2] = 0.25  # constant image -> 0
    got = norm_neg1to1(torch.from_numpy(x)).numpy()
    ref = np.asarray(flax_degrade.norm_neg1to1(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-7)
    assert np.all(got[2] == 0.0)
    mask = fixed_scan_mask((SIZE, SIZE), 1 / 8)
    np.testing.assert_array_equal(
        apply_partial_scan(torch.from_numpy(got), mask).numpy(),
        np.asarray(flax_degrade.apply_partial_scan(
            jnp.asarray(got), jnp.asarray(mask.numpy()))))


def test_infilling_example_with_emx_draws():
    """emx draws each image's D4 choice from fold_in(key, 0); fed the same
    choices, the port's batched example equals emx's per image."""
    x = synthetic_micrographs(4, SIZE, seed=2)
    x[1, 3, 4] = np.nan
    mask = fixed_scan_mask((SIZE, SIZE), 1 / 16)
    keys = jax.random.split(jax.random.key(5), 4)
    d4 = [int(jax.random.randint(jax.random.fold_in(k, 0), (), 0, 8))
          for k in keys]
    lq, truth = infilling_example(mask).apply({"d4": torch.tensor(d4)},
                                              torch.from_numpy(x))
    for i, k in enumerate(keys):
        rl, rt = flax_degrade.infilling_example(
            k, jnp.asarray(x[i]), jnp.asarray(mask.numpy()))
        np.testing.assert_allclose(lq[i].numpy(), np.asarray(rl), atol=1e-7)
        np.testing.assert_allclose(truth[i].numpy(), np.asarray(rt),
                                   atol=1e-7)


def test_occlude_and_box_downsample_match_emx():
    x = synthetic_micrographs(6, SIZE, seed=3)
    draws = {k: [] for k in ("choice", "half1", "half2", "side", "d4")}
    refs = []
    for i in range(6):
        key = jax.random.key(40 + i)
        k_choice, k_a, k_b, k_flip = jax.random.split(key, 4)
        n = SIZE
        draws["choice"].append(int(jax.random.randint(k_choice, (), 0, 3)))
        draws["half1"].append(int(jax.random.randint(k_a, (), 0,
                                                     n // 2 + 1)) // 2)
        draws["half2"].append(int(jax.random.randint(k_b, (), 0,
                                                     n // 2 + 1)) // 2)
        draws["side"].append(int(jax.random.randint(k_a, (), 0, n + 1)))
        draws["d4"].append(int(jax.random.randint(k_flip, (), 0, 8)))
        refs.append(np.asarray(flax_degrade.occlude(key, jnp.asarray(x[i]))))
    got = occlude(torch.from_numpy(x), {k: torch.tensor(v)
                                        for k, v in draws.items()})
    np.testing.assert_array_equal(got.numpy(), np.stack(refs))
    assert len(set(draws["choice"])) > 1
    np.testing.assert_allclose(
        box_downsample(torch.from_numpy(x), 4).numpy(),
        np.asarray(flax_degrade.box_downsample(jnp.asarray(x), 4)),
        atol=1e-7)


@pytest.mark.parametrize("n_in,n_out", [(48, 16), (192, 64), (13, 5),
                                        (16, 32)])
def test_resize_linear_matches_jax(n_in, n_out):
    """jax.image.resize(..., "linear") antialiases a shrink (a triangle
    filter widened by the factor); F.interpolate does not."""
    x = np.random.default_rng(0).random((2, n_in, n_in, 1)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, n_out, n_out, 1),
                                      "linear"))
    got = resize_linear(torch.from_numpy(x), (n_out, n_out)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _emx_offsets(key, n):
    padded = n + 2 * ((3 * n) // 4)
    out = []
    for kk, size in zip(jax.random.split(key, 3),
                        (n // 4, n // 2, (3 * n) // 4)):
        ky, kx = jax.random.split(kk)
        out.append(tuple(int(jax.random.randint(k, (), 0, padded - size + 1))
                         for k in (ky, kx)))
    return tuple(out)


@pytest.mark.parametrize("n", [64, 256])
def test_multiscale_crops_match_emx(n):
    x = synthetic_micrographs(2, n, seed=7) * 2 - 1
    key = jax.random.key(n)
    ref = flax_crops(key, jnp.asarray(x))
    got = multiscale_crops(_emx_offsets(key, n), torch.from_numpy(x))
    for r, g, tol in zip(ref, got, (0.0, 0.0, 1e-6)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)


@pytest.fixture(scope="module")
def flax_nets():
    """emx's tiny generator and discriminator variables (one jitted init
    each) and an input batch in [-1, 1] with the -1 fill."""
    x = (synthetic_micrographs(2, SIZE, seed=11) * 2 - 1).astype(np.float32)
    mask = np.asarray(flax_degrade.fixed_scan_mask((SIZE, SIZE), 1 / 8))
    x = np.where(mask, x, -1.0).astype(np.float32)
    gen = FlaxGenerator(FlaxConfig.tiny())
    gvars = jax.jit(lambda k, a: gen.init(k, a))(jax.random.key(0),
                                                 jnp.asarray(x))
    crops = flax_crops(jax.random.key(3), jnp.asarray(x))
    disc = FlaxDiscriminator(FlaxConfig.tiny())
    dvars = jax.jit(lambda k, c: disc.init(k, c))(jax.random.key(1), crops)
    return {"x": x, "gen": _flat(gvars["params"]),
            "disc": _flat(dvars["params"]), "gvars": gvars, "dvars": dvars,
            "crops": [np.asarray(c) for c in crops]}


@pytest.mark.parametrize("dtype,tol,mean_tol", [("float32", 5e-4, 1e-5),
                                                ("bfloat16", 0.1, 0.02)])
def test_generator_matches_emx(flax_nets, dtype, tol, mean_tol):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref = np.asarray(FlaxGenerator(dataclasses.replace(
        FlaxConfig.tiny(), dtype=jdt)).apply(flax_nets["gvars"],
                                             jnp.asarray(flax_nets["x"])))
    port = load_flax_params(InfillingGenerator(dataclasses.replace(
        InfillingConfig.tiny(), dtype=tdt), device=CPU), flax_nets["gen"])
    with torch.no_grad():
        got = port(torch.from_numpy(flax_nets["x"])).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol)
    assert np.abs(got - ref).mean() <= mean_tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_discriminator_matches_emx(flax_nets, dtype, tol):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    crops = flax_nets["crops"]
    p_ref, f_ref = FlaxDiscriminator(dataclasses.replace(
        FlaxConfig.tiny(), dtype=jdt)).apply(
        flax_nets["dvars"], [jnp.asarray(c) for c in crops])
    port = load_flax_params(MultiscaleDiscriminator(dataclasses.replace(
        InfillingConfig.tiny(), dtype=tdt), device=CPU), flax_nets["disc"])
    with torch.no_grad():
        p, feats = port(tuple(torch.from_numpy(c) for c in crops))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=tol)
    assert len(feats) == len(f_ref) == 3 * len(InfillingConfig.tiny()
                                              .disc_features)
    for a, b in zip(feats, f_ref):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   atol=tol * 10, rtol=tol)


def test_gan_state_round_trip(flax_nets, tmp_path):
    """emx's save_pytree_npz of a tiny GAN state loads into the port's
    nets; the port's save_gan_state of them loads back in emx's
    load_pytree_like with every array equal."""
    gvars, dvars = flax_nets["gvars"], flax_nets["dvars"]
    tree = {"gen_params": gvars["params"], "gen_stats": {},
            "disc_params": dvars["params"], "disc_stats": {},
            "pred_avg": jnp.asarray(0.25), "pred_avg_real": jnp.asarray(0.75)}
    meta = {"step": 7, "scale": 0.5}
    flax_save_pytree(str(tmp_path / "emx.npz"), tree, meta=meta)
    cfg = InfillingConfig.tiny()
    trainer = GANTrainer(InfillingGenerator(cfg, device=CPU),
                         MultiscaleDiscriminator(cfg, device=CPU),
                         GANConfig(log_every=0))
    state = trainer.new_state()
    assert load_gan_state(str(tmp_path / "emx.npz"), state) == meta
    assert float(state.pred_avg) == 0.25
    assert float(state.pred_avg_real) == 0.75
    for k, v in flax_nets["gen"].items():
        np.testing.assert_array_equal(to_flax_params(state.gen)[0][k], v)
    save_gan_state(str(tmp_path / "port.npz"), state, meta)
    back, back_meta = flax_load_pytree(str(tmp_path / "port.npz"), tree)
    assert back_meta == meta
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(tree)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(kp))

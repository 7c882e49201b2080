"""One train step of the zoo ladder's families (emx_torch/bench/
zoo_ladder.py) against emx's (emx/bench/zoo_ladder.py) on the CPU, on
emx's parameter trees at random values (tests/torch_zoo_helpers.py) and
emx's draws.

emx's steps are closures inside its run_* functions; `_emx_*_step`
below restate each one with emx's modules and optax, line for line. The
forward and backward run in float64 on both sides (flax dtype float64
under jax.enable_x64, the port's torch.float64; parameters and Adam
float32), as tests/test_torch_train.py does, because flax's float32
BatchNorm statistics drift from any other order of summation. Outputs
that emx casts to float32 (the embedder's features, the manifold's
codes and images) are float32 on both sides.

Tolerances: losses rtol 1e-5; parameters (and BatchNorm statistics)
after the step atol 1e-6, rtol 1e-5. The draws fed in: the latent
encoder's dropout keep mask (recovered from emx's train-mode latent),
the embedder's crop corners and rotations (jax.random, as emx's
make_pairs draws them)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import emx.nn as E
from emx.nn.autoencoder import embedder_metric_loss as emx_metric_loss
from emx.nn.manifold import manifold_losses as emx_manifold_losses
from emx.utils.image import flip_rotate as emx_flip_rotate
from emx_torch.bench import zoo_ladder as zl
from emx_torch.nn.autoencoder import (EmbedderConfig, SmallAEConfig,
                                      SmallAutoencoder, UnsupervisedEmbedder,
                                      XceptionAEConfig, XceptionAutoencoder,
                                      embedder_metric_loss)
from emx_torch.nn.latent import LatentAEConfig, LatentAutoencoder
from emx_torch.nn.manifold import ManifoldConfig, SharedManifoldTranslator
from emx_torch.serve.convert import load_flax_params, to_flax_params
from torch_zoo_helpers import (EMBEDDER, LATENT, XCEPTION, as_emx,
                               emx_variables, ref_jit)

CPU = "cpu"
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _imgs(n, size, seed):
    from emx.data.pipeline import synthetic_micrographs
    return synthetic_micrographs(n, size, seed=seed)


def _check_params(port_model, params, stats=None):
    got_p, got_s = to_flax_params(port_model)
    for ref, got in ((_flat(params), got_p), (_flat(stats or {}), got_s)):
        assert set(ref) == set(got)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=1e-5,
                                       err_msg=k)


def _emx_recon_step(model, variables, imgs, key, lr=1e-3):
    """emx/bench/zoo_ladder.py _train_recon's step, one call."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    has_stats = bool(jax.tree_util.tree_leaves(stats))
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @ref_jit
    def step(params, stats, opt_state, key, imgs):
        def loss_fn(p):
            v = {"params": p}
            rngs = {"dropout": key}
            if has_stats:
                v["batch_stats"] = stats
                out, upd = model.apply(v, imgs, train=True, rngs=rngs,
                                       mutable=["batch_stats"])
                return jnp.mean((out - imgs) ** 2), upd["batch_stats"]
            out = model.apply(v, imgs, train=True, rngs=rngs)
            return jnp.mean((out - imgs) ** 2), stats

        (loss, new_stats), g = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), new_stats, loss

    return step(params, stats, opt_state, key, imgs)


RECON = {
    # name: (emx model, port model, size)
    "small_ae": (lambda dt: E.SmallAutoencoder(E.SmallAEConfig(
        features=(8, 8, 16), bottleneck=8, dtype=dt)),
        lambda: SmallAutoencoder(SmallAEConfig(features=(8, 8, 16),
                                               bottleneck=8, dtype=F64),
                                 device=CPU), 32),
    "xception_ae": (lambda dt: E.XceptionAutoencoder(E.XceptionAEConfig(
        **XCEPTION, dtype=dt)),
        lambda: XceptionAutoencoder(XceptionAEConfig(**XCEPTION, dtype=F64),
                                    device=CPU), 32),
    "latent_ae": (lambda dt: E.LatentAutoencoder(E.LatentAEConfig(
        **LATENT, dtype=dt)),
        lambda: LatentAutoencoder(LatentAEConfig(**LATENT, dtype=F64),
                                  device=CPU), 8),
}


@pytest.mark.parametrize("name", sorted(RECON))
def test_recon_step_matches_emx(name):
    make_emx, make_port, size = RECON[name]
    imgs = _imgs(4, size, 11)
    key = jax.random.key(3)
    flat32 = emx_variables(make_emx(jnp.float32), jnp.asarray(imgs[:2]),
                           train=False)
    v32 = as_emx(flat32)
    port = load_flax_params(make_port(), flat32["params"],
                            flat32.get("batch_stats"))
    with jax.enable_x64():
        model = make_emx(jnp.float64)
        params, stats, loss = _emx_recon_step(model, v32, jnp.asarray(imgs),
                                              key)
        kw = {}
        if name == "latent_ae":
            # emx's dropout keep mask: where its train-mode latent is 0.
            z = ref_jit(lambda p, x: model.apply(
                {"params": p}, x, True, rngs={"dropout": key},
                method=E.LatentAutoencoder.encode))(v32["params"],
                                                    jnp.asarray(imgs))
            kw["dropout_keep"] = torch.from_numpy(np.asarray(z) != 0)
            assert 0 < kw["dropout_keep"].float().mean() < 1
    opt = torch.optim.Adam(port.parameters(), lr=1e-3)
    got = zl.recon_step(port, opt, torch.from_numpy(imgs), **kw)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    _check_params(port, params, stats)


def emx_crop_draws(key, b, hi):
    """emx's make_pairs draws, as arrays (b, 2): crop j of image i from
    fold_in(split(key, b)[i], 10 + j)."""
    out = {"oy": np.zeros((b, 2), np.int64), "ox": np.zeros((b, 2), np.int64),
           "rot": np.zeros((b, 2), np.int64)}
    for i, k in enumerate(jax.random.split(key, b)):
        for j in range(2):
            kc = jax.random.fold_in(k, 10 + j)
            for n, (name, top) in enumerate((("oy", hi), ("ox", hi),
                                             ("rot", 4))):
                out[name][i, j] = int(jax.random.randint(
                    jax.random.fold_in(kc, n), (), 0, top))
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _emx_make_pairs(key, batch_imgs, size, crop):
    """emx/bench/zoo_ladder.py run_embedder's make_pairs."""
    ks = jax.random.split(key, batch_imgs.shape[0])
    hi = size - crop

    def one_crop(k, img):
        oy = jax.random.randint(jax.random.fold_in(k, 0), (), 0, hi)
        ox = jax.random.randint(jax.random.fold_in(k, 1), (), 0, hi)
        c = jax.lax.dynamic_slice(img, (oy, ox), (crop, crop))
        return emx_flip_rotate(c, jax.random.randint(
            jax.random.fold_in(k, 2), (), 0, 4))

    def two(k, img):
        return jnp.stack([one_crop(jax.random.fold_in(k, 10), img),
                          one_crop(jax.random.fold_in(k, 11), img)])

    return jax.vmap(two)(ks, batch_imgs).reshape(-1, crop, crop)


def _emx_info_nce(e, temp=0.1):
    e = e / jnp.maximum(jnp.linalg.norm(e, axis=-1, keepdims=True), 1e-8)
    logits = (e @ e.T) / temp
    n = e.shape[0]
    logits = jnp.where(jnp.eye(n, dtype=bool), -1e9, logits)
    partner = jnp.arange(n) ^ 1
    return jnp.mean(
        -jax.nn.log_softmax(logits, axis=-1)[jnp.arange(n), partner])


def test_info_nce_matches_emx():
    """The InfoNCE loss of embedder_nce and its gradient (the step runs
    the metric loss; the two share make_pairs and the trunk)."""
    e = np.random.default_rng(2).standard_normal((8, 5)).astype(np.float32)
    ref, gref = ref_jit(jax.value_and_grad(_emx_info_nce))(jnp.asarray(e))
    t = torch.from_numpy(e).requires_grad_(True)
    got = zl.info_nce(t)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gref), atol=1e-6)


@pytest.mark.parametrize("loss", ["metric"])
def test_embedder_step_matches_emx(loss):
    size, crop, b = 48, 32, 3
    imgs = _imgs(b, size, 12)
    key = jax.random.key(4)
    flat32 = emx_variables(E.UnsupervisedEmbedder(E.EmbedderConfig(
        **EMBEDDER)), jnp.zeros((2, crop, crop)), train=False)
    v32 = as_emx(flat32)
    port = load_flax_params(UnsupervisedEmbedder(EmbedderConfig(
        **EMBEDDER, dtype=F64), device=CPU), flat32["params"])
    emx_loss = emx_metric_loss if loss == "metric" else (
        lambda e: _emx_info_nce(e.astype(jnp.float32)))
    # emx's crops as the ladder draws them (int32); its step below takes
    # them as they are, the port's step draws them again from `draws`.
    draws = emx_crop_draws(key, b, size - crop)
    ref_pairs = ref_jit(lambda k, x: _emx_make_pairs(k, x, size, crop))(
        key, jnp.asarray(imgs))
    got = zl.make_pairs(torch.from_numpy(imgs), draws, crop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_pairs))
    with jax.enable_x64():
        model = E.UnsupervisedEmbedder(E.EmbedderConfig(
            **EMBEDDER, dtype=jnp.float64))
        opt = optax.adam(1e-4)

        @ref_jit
        def step(params, pairs):
            def loss_fn(p):
                return emx_loss(model.apply({"params": p}, pairs,
                                            train=True, features=True))

            val, g = jax.value_and_grad(loss_fn)(params)
            updates, _ = opt.update(g, opt.init(params))
            return optax.apply_updates(params, updates), val

        params, val = step(v32["params"], ref_pairs)
    opt = torch.optim.Adam(port.parameters(), lr=1e-4)
    got = zl.embedder_step(port, opt, torch.from_numpy(imgs), draws, crop,
                           embedder_metric_loss if loss == "metric"
                           else zl.info_nce)
    np.testing.assert_allclose(float(got), float(val), rtol=1e-5)
    _check_params(port, params)


def test_manifold_step_matches_emx():
    size = 32
    a = _imgs(3, size, 13)
    b = 1.0 - _imgs(3, size, 14)
    flat32 = emx_variables(E.SharedManifoldTranslator(
        E.ManifoldConfig.tiny()), jnp.asarray(a), jnp.asarray(b),
        train=False)
    v32 = as_emx(flat32)
    port = load_flax_params(SharedManifoldTranslator(dataclasses.replace(
        ManifoldConfig.tiny(), dtype=F64), device=CPU), flat32["params"])
    with jax.enable_x64():
        model = E.SharedManifoldTranslator(dataclasses.replace(
            E.ManifoldConfig.tiny(), dtype=jnp.float64))
        params = v32["params"]
        main_keys = [k for k in params if k != "confuser"]
        m_opt, c_opt = optax.adam(2e-4), optax.adam(2e-4)

        @ref_jit
        def step(params, a, b):
            """emx/bench/zoo_ladder.py run_manifold's step."""
            def m_loss(mp):
                p = dict(params)
                p.update(mp)
                out = model.apply({"params": p}, a, b, train=True)
                losses = emx_manifold_losses(out, a, b)
                return losses["recon"] + losses["confusion"], losses

            mp = {k: params[k] for k in main_keys}
            (_, losses), mg = jax.value_and_grad(m_loss, has_aux=True)(mp)
            m_up, _ = m_opt.update(mg, m_opt.init(mp))
            params = dict(params)
            params.update(optax.apply_updates(mp, m_up))

            def c_loss(cp):
                p = dict(params)
                p["confuser"] = cp
                out = model.apply({"params": p}, a, b, train=True)
                return emx_manifold_losses(out, a, b)["confuser_bce"]

            cg = jax.grad(c_loss)(params["confuser"])
            c_up, _ = c_opt.update(cg, c_opt.init(params["confuser"]))
            params["confuser"] = optax.apply_updates(params["confuser"],
                                                     c_up)
            return params, losses["recon"]

        params, recon = step(params, jnp.asarray(a), jnp.asarray(b))
    main = [p for n, p in port.named_parameters()
            if not n.startswith("confuser.")]
    got = zl.manifold_step(port, torch.optim.Adam(main, lr=2e-4),
                           torch.optim.Adam(port.confuser.parameters(),
                                            lr=2e-4),
                           torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(got), float(recon), rtol=1e-5)
    _check_params(port, params)


def test_ladder_helpers():
    """The ladder's own pieces: the anchors, the crop draws' ranges, the
    kernel family's degrade (Poisson counts rescaled per image, the
    target at the noisy image's mean)."""
    gen = torch.Generator().manual_seed(0)
    d = zl.crop_draws(gen, 5, 7)
    assert all(v.shape == (5, 2) for v in d.values())
    assert int(d["oy"].max()) < 7 and int(d["rot"].max()) < 4
    imgs = torch.from_numpy(_imgs(3, 32, 15))
    lq, tgt = zl.kernels_degrade(gen, imgs)
    assert float(lq.amin()) == 0.0 and float(lq.amax()) == 1.0
    np.testing.assert_allclose(tgt.mean(dim=(-2, -1)).numpy(),
                               lq.mean(dim=(-2, -1)).numpy(), rtol=1e-5)
    val = zl._data(16, 96, 99, CPU)
    assert round(zl._const_anchor(val), 2) == 15.12   # the record's


def _fake_card(monkeypatch) -> list[float]:
    """The card's clock, on the CPU: `_train_loop` times as it does on the
    card, with a clock that a test moves by hand."""
    now = [0.0]
    monkeypatch.setattr(zl, "_timed", lambda device: True)
    monkeypatch.setattr(zl, "time",
                        types.SimpleNamespace(perf_counter=lambda: now[0]))
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: 2 ** 30)
    return now


def test_train_loop_times_every_step_after_the_first(monkeypatch):
    """Five steps: the first (1 s) untimed, the other four (10 ms each)
    each counted once."""
    now = _fake_card(monkeypatch)

    def step(i):
        now[0] += 1.0 if i == 0 else 0.01
        return i

    outs, rates = zl._train_loop(torch.device("cpu"), 5, step)
    assert outs == [0, 1, 2, 3, 4]
    assert rates == {"steps_per_s": 100.0, "step_ms": 10.0, "peak_gib": 1.0}
    assert zl._train_loop(torch.device("cpu"), 1, step) == ([0], {})


def test_family_rates_leave_out_the_evaluation(monkeypatch, tmp_path):
    """A family's rate is its train steps' alone: the validation forward
    and scoring after the loop (100 s here) do not count; --no-rates
    leaves the rates out of the results."""
    now = _fake_card(monkeypatch)
    step, psnr, n = zl.recon_step, zl._psnr_mean, [0]

    def timed_step(*a, **kw):
        now[0] += 1.0 if n[0] == 0 else 0.01
        n[0] += 1
        return step(*a, **kw)

    def slow_eval(*a):
        now[0] += 100.0
        return psnr(*a)

    monkeypatch.setattr(zl, "recon_step", timed_step)
    monkeypatch.setattr(zl, "_psnr_mean", slow_eval)
    r = zl.run_small_ae(4, 0.25, 16, device=CPU)
    assert n[0] == 4
    assert (r["steps_per_s"], r["step_ms"], r["peak_gib"]) == (100.0, 10.0,
                                                               1.0)
    out = zl.main(str(tmp_path), 3, 0.25, 16, families=["small_ae"],
                  device=CPU, rates=False)
    assert not set(zl.RATE_KEYS) & set(out["families"]["small_ae"])

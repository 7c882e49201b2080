"""The nested VAE-GAN (emx_torch/nn/vaegan.py) and its ladder step
(emx_torch/bench/zoo_ladder.py vaegan_step) against emx's on the CPU,
on emx's parameter and spectral trees at random values
(tests/torch_zoo_helpers.py), and emx's draws.

The step runs in float32 on both sides: under jax.enable_x64 emx's
gradient-penalty mix becomes float64 and its float32 spectral convs
refuse it. So after one step Adam's +-lr moves agree wherever a
gradient is well above rounding (atol 1e-6, rtol 1e-5); where emx's
gradient is under 1e-5 in size (the conv biases ahead of an instance
norm, whose true gradient is 0) the bound is 2 lr, Adam's widest move.
The spectral u vectors after the step within 1e-5; losses rtol 1e-4.
The forward pieces: outputs within 1e-5 (float32), the gradient
penalty and its gradient against jax.grad within rtol 1e-4, polar_warp
exactly, cutout within 1e-6 (its fill is a float32 mean summed in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from emx.nn import vaegan as ev
from emx_torch.bench import zoo_ladder as zl
from emx_torch.nn import vaegan as pv
from emx_torch.serve.convert import load_flax_params, to_flax_variables
from torch_zoo_helpers import as_emx, emx_variables, ref_jit

CPU = "cpu"
SIZE, B, LR = 32, 3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def nets():
    from emx.data.pipeline import synthetic_micrographs

    imgs = synthetic_micrographs(B, SIZE, seed=17)
    cfg = ev.VAEGANConfig.tiny()
    model, critic = ev.NestedVAEGAN(cfg), ev.SpectralCritic(cfg)
    k0 = jax.random.key(0)
    variables = as_emx(emx_variables(model, jnp.asarray(imgs), k0,
                                     train=False))
    cvars = as_emx(emx_variables(critic, jnp.asarray(imgs), seed=1))
    return {"imgs": imgs, "model": model, "critic": critic,
            "params": variables["params"], "cparams": cvars["params"],
            "spec": cvars["spectral"]}


def _port(nets):
    cfg = pv.VAEGANConfig.tiny()
    model = load_flax_params(pv.NestedVAEGAN(cfg, device=CPU),
                             _flat(nets["params"]))
    critic = load_flax_params(pv.SpectralCritic(cfg, device=CPU),
                              _flat(nets["cparams"]),
                              spectral=_flat(nets["spec"]))
    return model, critic


def test_forward_and_critic_match_emx(nets):
    model, critic = _port(nets)
    x = jnp.asarray(nets["imgs"])
    eps = np.array(jax.random.normal(jax.random.key(2), (B, 8)))
    out = ref_jit(lambda p, x: nets["model"].apply(
        {"params": p}, x, jax.random.key(2), train=True))(nets["params"], x)
    got = model(torch.from_numpy(nets["imgs"]),
                torch.from_numpy(eps), train=True)
    for k in ("recon", "z", "mu", "logvar", "embedding"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(out[k]), atol=1e-5, err_msg=k)
    cv = {"params": nets["cparams"], "spectral": nets["spec"]}
    ref, upd = ref_jit(lambda cv, x: nets["critic"].apply(
        cv, x, mutable=["spectral"]))(cv, x)
    with torch.no_grad():
        gotc = critic(torch.from_numpy(nets["imgs"]), update=True)
    np.testing.assert_allclose(gotc.numpy(), np.asarray(ref), atol=1e-5)
    spec = to_flax_variables(critic)["spectral"]
    for k, v in _flat(upd["spectral"]).items():
        np.testing.assert_allclose(spec[k], v, atol=1e-5, err_msg=k)


def test_gradient_penalty_and_augments_match_emx(nets):
    _, critic = _port(nets)
    cv = {"params": nets["cparams"], "spectral": nets["spec"]}
    real = jnp.asarray(nets["imgs"])
    fake = jnp.asarray(np.random.default_rng(3).random(real.shape),
                       jnp.float32)
    key = jax.random.key(4)
    mix = np.asarray(jax.random.uniform(key, (B, 1, 1)))[:, 0, 0]

    def emx_gp(cp):
        return ev.gradient_penalty(
            lambda x: nets["critic"].apply({"params": cp,
                                            "spectral": nets["spec"]}, x),
            key, real, fake)

    ref, gref = ref_jit(jax.value_and_grad(emx_gp))(nets["cparams"])
    got = pv.gradient_penalty(critic, torch.from_numpy(mix),
                              torch.from_numpy(np.asarray(real)),
                              torch.from_numpy(np.asarray(fake)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-4)
    for (name, p), (k, g) in zip(critic.named_parameters(),
                                 sorted(_flat(gref).items())):
        assert name.replace(".", "/") == k
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4, atol=1e-7)
    # polar warp and cutout, exactly; the KL term.
    img = np.random.default_rng(5).random((2, SIZE, SIZE)).astype(np.float32)
    np.testing.assert_array_equal(
        pv.polar_warp(torch.from_numpy(img)).numpy(),
        np.asarray(ref_jit(ev.polar_warp)(jnp.asarray(img))))
    keys = jax.random.split(jax.random.key(6), 2)
    ref = np.asarray(ref_jit(jax.vmap(ev.cutout))(keys, jnp.asarray(img)))
    corners = _cutout_corners(keys, SIZE)
    np.testing.assert_allclose(
        pv.cutout(torch.from_numpy(img), corners).numpy(), ref, atol=1e-6)
    mu, lv = (np.random.default_rng(7).standard_normal((3, 4)).astype(
        np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(pv.kl_divergence(torch.from_numpy(mu), torch.from_numpy(lv))),
        float(ev.kl_divergence(jnp.asarray(mu), jnp.asarray(lv))), rtol=1e-6)


def _cutout_corners(keys, n):
    """emx's cutout corner for each key, (len(keys), 2) int64: the top
    and left drawn from the two halves of split(key)."""
    s = max(1, int(0.25 * n))

    def one(key):
        return jnp.stack([jax.random.randint(k, (), 0, n - s + 1)
                          for k in jax.random.split(key)])

    return torch.from_numpy(np.asarray(ref_jit(jax.vmap(one))(keys),
                                       np.int64))


def emx_step_draws(key, b, n, latent):
    """The draws of emx's vaegan step at `key` (run_vaegan's step and
    vaegan_losses), in the port's vaegan_step_draws layout."""
    k_c, k_g, k_gp = jax.random.split(key, 3)
    k_vae, k_aug, _ = jax.random.split(k_g, 3)
    return {
        "c_gp": torch.from_numpy(np.asarray(jax.random.uniform(
            k_gp, (b, 1, 1)))[:, 0, 0].copy()),
        "eps": torch.from_numpy(np.asarray(jax.random.normal(
            k_vae, (b, latent)))),
        "cutout": _cutout_corners(jax.random.split(k_aug, b), n)}


def test_vaegan_step_matches_emx(nets):
    """emx/bench/zoo_ladder.py run_vaegan's step, restated with emx's
    modules and optax, against the port's vaegan_step on its draws, at
    the kl 0.1 / critic 0.1 weights of two of the ladder's variants."""
    wass, kl = 0.1, 0.1
    model, critic = nets["model"], nets["critic"]
    imgs = jnp.asarray(nets["imgs"])
    key = jax.random.key(8)
    g_opt, c_opt = optax.adam(LR, b1=0.5), optax.adam(LR, b1=0.5)

    @ref_jit
    def step(params, c_params, c_spec, key, imgs, w):
        k_c, k_g, k_gp = jax.random.split(key, 3)
        out = model.apply({"params": params}, imgs, k_c, train=False)
        fake = jax.lax.stop_gradient(out["recon"])

        def c_loss(cp):
            real_s, spec1 = critic.apply({"params": cp, "spectral": c_spec},
                                         imgs, mutable=["spectral"])
            fake_s, spec2 = critic.apply(
                {"params": cp, "spectral": spec1["spectral"]}, fake,
                mutable=["spectral"])
            gp = ev.gradient_penalty(
                lambda x: critic.apply(
                    {"params": cp, "spectral": spec2["spectral"]}, x),
                k_gp, imgs, fake)
            return (jnp.mean(fake_s) - jnp.mean(real_s) + 10.0 * gp,
                    spec2["spectral"])

        (cl, new_spec), cg = jax.value_and_grad(c_loss, has_aux=True)(
            c_params)
        c_up, _ = c_opt.update(cg, c_opt.init(c_params))
        c_params = optax.apply_updates(c_params, c_up)

        def g_loss(p):
            return ev.vaegan_losses(
                model, {"params": p}, critic,
                {"params": c_params, "spectral": new_spec}, imgs, k_g,
                weights=ev.VAEGANLossWeights(kl=kl, wass=w))

        (gl, parts), gg = jax.value_and_grad(g_loss, has_aux=True)(params)
        g_up, _ = g_opt.update(gg, g_opt.init(params))
        return (optax.apply_updates(params, g_up), c_params, new_spec,
                cl, gl, parts["mse"], gg, cg)

    params, c_params, spec, cl, gl, mse, gg, cg = step(
        nets["params"], nets["cparams"], nets["spec"], key, imgs,
        jnp.float32(wass))
    pmodel, pcritic = _port(nets)
    out = zl.vaegan_step(
        pmodel, pcritic,
        torch.optim.Adam(pmodel.parameters(), lr=LR, betas=(0.5, 0.999)),
        torch.optim.Adam(pcritic.parameters(), lr=LR, betas=(0.5, 0.999)),
        torch.from_numpy(nets["imgs"]),
        emx_step_draws(key, B, SIZE, 8), wass, kl)
    for name, ref in (("critic_loss", cl), ("total", gl), ("mse", mse)):
        np.testing.assert_allclose(float(out[name]), float(ref), rtol=1e-4,
                                   err_msg=name)
    for port, ref, grads in ((pmodel, params, gg), (pcritic, c_params, cg)):
        got = to_flax_variables(port)["params"]
        g = _flat(grads)
        for k, v in _flat(ref).items():
            bound = 1e-6 + 1e-5 * np.abs(v) + np.where(
                np.abs(g[k]) < 1e-5, 2 * LR, 0.0)
            assert np.all(np.abs(got[k] - v) <= bound), k
    got = to_flax_variables(pcritic)["spectral"]
    for k, v in _flat(spec).items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)

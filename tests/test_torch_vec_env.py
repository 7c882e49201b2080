"""The port's batched autofocus env (emx_torch/scope/vec_env.py) against
emx's on the CPU: the specimen pool, the noiseless acquire, and a step's
semantics on the same auto-reset draws (emx's `_sample_start` answered
with them; its draws come from jax.random, which the port cannot
reproduce), with dose 0, so neither side draws noise.

Tolerances: frames within 2e-5 (float32 FFTs of two libraries at
offsets of 0.3 or more from focus, where the frame has contrast);
everything else equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emx.scope.vec_env as emx_vec
from emx_torch.scope import vec_env

CPU = torch.device("cpu")
CFG = dict(batch=6, image_size=32, num_specimens=40, max_z_dist=2.0,
           max_episode_steps=3, specimen_seed=7)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def envs():
    ref = emx_vec.VecFresnelEnv(emx_vec.VecFresnelConfig(**CFG, dose=0.0))
    port = vec_env.VecFresnelEnv(
        vec_env.VecFresnelConfig(**CFG, dose=0.0), device=CPU)
    return ref, port


@pytest.mark.parametrize("windowed", [True, False])
def test_specimen_pool_equals_emx(windowed):
    cfg = dict(CFG, windowed_pool=windowed)
    ref = emx_vec.VecFresnelEnv(emx_vec.VecFresnelConfig(**cfg))
    port = vec_env.VecFresnelEnv(vec_env.VecFresnelConfig(**cfg), device=CPU)
    np.testing.assert_array_equal(port._pool.numpy(), np.asarray(ref._pool))


def test_noiseless_acquire_matches_emx(envs):
    ref, port = envs
    idx = np.array([0, 5, 9, 17, 33, 39])
    z = np.array([0.3, -0.45, 1.2, -2.0, 0.9, 2.7], np.float32)
    want = ref._acquire(jax.random.key(0), ref._pool[idx], jnp.asarray(z))
    got = port.acquire(port._pool[torch.from_numpy(idx)], torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_step_semantics_on_injected_draws(envs):
    """From one state, a step whose shifts solve two lanes and whose step
    count ends a third, on the same auto-reset draws: the new state, the
    observations (finished lanes restarted), the shaped reward, done and
    the info equal emx's."""
    ref, port = envs
    z = np.array([0.4, -0.9, 1.7, -2.1, 0.6, 1.0], np.float32)
    spec = np.array([1, 2, 3, 4, 5, 6], np.int32)
    steps = np.array([0, 1, 2, 0, 1, 0], np.int32)
    shift = np.array([-0.3, 0.8, 1.5, 0.5, -1.6, -0.2], np.float32)
    z0 = np.array([1.5, -0.8, 0.7, -1.9, 0.5, 1.1], np.float32)
    spec0 = np.array([30, 31, 32, 33, 34, 35], np.int32)

    ref_prev = ref._acquire(None, ref._pool[spec], jnp.asarray(z))
    ref_env = emx_vec.VecFresnelEnv(ref.cfg)
    ref_env._sample_start = lambda key, n: (jnp.asarray(z0),
                                            jnp.asarray(spec0))
    ref_env._step = jax.jit(ref_env._step_impl)
    want = ref_env.step({"key": jax.random.key(0), "z": jnp.asarray(z),
                         "spec_idx": jnp.asarray(spec), "prev": ref_prev,
                         "steps": jnp.asarray(steps)}, shift)

    t = torch.from_numpy
    gen = torch.Generator().manual_seed(0)
    prev = port.acquire(port._pool[t(spec).long()], t(z))
    got = port.step({"generator": gen, "z": t(z), "spec_idx": t(spec).long(),
                     "prev": prev, "steps": t(steps)}, shift,
                    draws=(t(z0), t(spec0).long()))

    (ws, wo, wr, wd, wi), (gs, go, gr, gd, gi) = want, got
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert gd.numpy().tolist() == [True, True, True, False, False, False]
    for k in ("z", "spec_idx", "steps"):
        np.testing.assert_array_equal(gs[k].numpy(), np.asarray(ws[k]),
                                      err_msg=k)
    np.testing.assert_allclose(gs["prev"].numpy(), np.asarray(ws["prev"]),
                               atol=2e-5)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=2e-5)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    for k in ("distance", "solved", "raw_reward"):
        np.testing.assert_array_equal(gi[k].numpy(), np.asarray(wi[k]),
                                      err_msg=k)


def test_reset_and_draws_with_dose():
    """The port's own draws: start offsets in emx's range, one generator
    for draws and counts (the same seed, the same episodes), frames in
    [0, 1] with shot noise."""
    cfg = vec_env.VecFresnelConfig(**CFG)
    env = vec_env.VecFresnelEnv(cfg, device=CPU)
    (s1, o1), (s2, o2) = env.reset(seed=3), env.reset(seed=3)
    torch.testing.assert_close(o1, o2)
    mag = s1["z"].abs()
    assert bool(((mag >= 0.3 * cfg.max_z_dist)
                 & (mag <= cfg.max_z_dist)).all())
    assert o1.shape == (cfg.batch, cfg.image_size, cfg.image_size, 3)
    assert float(o1[..., :2].min()) == 0.0 and float(o1[..., :2].max()) == 1.0
    assert bool((o1[..., 2] == 0).all())
    z0, spec0 = env.step_draws(s1)
    z0b, spec0b = env.step_draws(s2)
    torch.testing.assert_close(z0, z0b)
    state, obs, shaped, done, info = env.step(s1, torch.full((cfg.batch,),
                                                             0.5))
    torch.testing.assert_close(obs[..., 2][~done],
                               torch.full_like(obs[..., 2][~done], 0.5))
    assert bool((state["steps"][done] == 0).all())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        emx_vec.VecFresnelConfig(**CFG))

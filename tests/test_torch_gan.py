"""The port's GAN trainer (emx_torch/train/gan.py) against emx's on the CPU.

One G+D step of the tiny infilling GAN on emx's flax-initialised
parameters and emx's own draws (example D4 choices, both crop sets, the
three uniforms), with the forward and backward in float64 on both sides
(flax dtype float64 under jax.enable_x64, the port's torch.float64;
parameters float32): the same losses and metrics, and the same updated
parameters, for a generator step and then a discriminator step. emx's
host loop (`fit`) against the port's on scripted D(fake) sequences:
trainee switching, forced flips and collapse rollback call the step
with the same trainee at the same steps. Checkpoint, resume and the
gated optimizer state need no JAX."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from emx.data.degrade import fixed_scan_mask as flax_mask
from emx.data.degrade import infilling_example as flax_example
from emx.data.pipeline import synthetic_micrographs
from emx.nn.infilling import InfillingConfig as FlaxConfig
from emx.nn.infilling import InfillingGenerator as FlaxGenerator
from emx.nn.infilling import MultiscaleDiscriminator as FlaxDiscriminator
from emx.parallel import make_mesh
from emx.train.gan import GANConfig as FlaxGANConfig
from emx.train.gan import GANState as FlaxGANState
from emx.train.gan import GANTrainer as FlaxGANTrainer
from emx_torch.data.degrade import fixed_scan_mask, infilling_example
from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                    MultiscaleDiscriminator)
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.train import Checkpointer
from emx_torch.train.gan import (GANConfig, GANTrainer, _adapt_rate,
                                 _flip_prob, clip_by_global_norm_)

SIZE, B = 32, 2
CPU = "cpu"
GAN_KW = dict(gen_lr=1e-3, disc_lr=1e-3, mse_weight=10.0, log_every=0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def emx_draws(key_data, step: int, b: int, n: int) -> dict:
    """The values emx's GAN step draws at `step` (emx/train/gan.py:
    166-229), in the port's step_draws layout."""
    k = jax.random.fold_in(jax.random.wrap_key_data(key_data), step)
    k_ex, k_cf, k_cr, k_ff, k_fr, k_lab = jax.random.split(k, 6)
    d4 = [int(jax.random.randint(jax.random.fold_in(kk, 0), (), 0, 8))
          for kk in jax.random.split(k_ex, b)]

    def offsets(key):
        padded = n + 2 * ((3 * n) // 4)
        out = []
        for kk, size in zip(jax.random.split(key, 3),
                            (n // 4, n // 2, (3 * n) // 4)):
            ky, kx = jax.random.split(kk)
            out.append(tuple(int(jax.random.randint(kz, (), 0,
                                                    padded - size + 1))
                             for kz in (ky, kx)))
        return tuple(out)

    return {"example": {"d4": torch.tensor(d4)},
            "crops_f": offsets(k_cf), "crops_r": offsets(k_cr),
            "flip_f": float(jax.random.uniform(k_ff)),
            "flip_r": float(jax.random.uniform(k_fr)),
            "label": float(jax.random.uniform(k_lab))}


@pytest.fixture(scope="module")
def emx_steps():
    """emx's tiny GAN: float32 variables from its init, then a generator
    step and a discriminator step in float64, with the draws of each."""
    mask = flax_mask((SIZE, SIZE), 1 / 16)
    data = synthetic_micrographs(B, SIZE, seed=21)
    example = functools.partial(flax_example, mask=mask)
    tr32 = FlaxGANTrainer(FlaxGenerator(FlaxConfig.tiny()),
                          FlaxDiscriminator(FlaxConfig.tiny()),
                          FlaxGANConfig(**GAN_KW), mesh=make_mesh(),
                          example_fn=example)
    s0 = jax.tree_util.tree_map(np.asarray, tr32.init(jnp.asarray(data)))
    out = {"data": data, "gen": _flat(s0.gen_params),
           "disc": _flat(s0.disc_params), "steps": []}
    with jax.enable_x64():
        cfg64 = dataclasses.replace(FlaxConfig.tiny(), dtype=jnp.float64)
        tr = FlaxGANTrainer(FlaxGenerator(cfg64), FlaxDiscriminator(cfg64),
                            FlaxGANConfig(**GAN_KW), mesh=make_mesh(),
                            example_fn=example)
        state = FlaxGANState(
            step=jnp.zeros((), jnp.int32), gen_params=s0.gen_params,
            gen_stats=s0.gen_stats, disc_params=s0.disc_params,
            disc_stats=s0.disc_stats,
            gen_opt=tr.gen_opt.init(s0.gen_params),
            disc_opt=tr.disc_opt.init(s0.disc_params), rng=s0.rng,
            pred_avg=jnp.asarray(0.5), pred_avg_real=jnp.asarray(0.5))
        for i, (do_gen, do_disc) in enumerate(((True, False),
                                               (False, True))):
            draws = emx_draws(s0.rng, i, B, SIZE)
            state, m = tr.step_fn(state, jnp.asarray(data),
                                  jnp.asarray(do_gen), jnp.asarray(do_disc))
            out["steps"].append({
                "draws": draws, "do": (do_gen, do_disc),
                "metrics": {k: float(v) for k, v in m.items()},
                "gen": _flat(state.gen_params),
                "disc": _flat(state.disc_params),
                "pred_avg": (float(state.pred_avg),
                             float(state.pred_avg_real))})
    return out


def _port_trainer(emx_steps, dtype=torch.float64, **kw):
    cfg = dataclasses.replace(InfillingConfig.tiny(), dtype=dtype)
    gen = load_flax_params(InfillingGenerator(cfg, device=CPU),
                           emx_steps["gen"])
    disc = load_flax_params(MultiscaleDiscriminator(cfg, device=CPU),
                            emx_steps["disc"])
    mask = fixed_scan_mask((SIZE, SIZE), 1 / 16)
    return GANTrainer(gen, disc, GANConfig(**{**GAN_KW, **kw}),
                      example_fn=infilling_example(mask))


def test_gan_steps_match_emx(emx_steps):
    """A generator step then a discriminator step on emx's draws: every
    metric within rtol 1e-5 (abs 1e-7), the EMAs within 1e-7, and both
    nets' parameters within atol 1e-6, rtol 1e-5 of emx's after each step
    (float64 compute, float32 parameters: the float32 rounding of the
    parameters' updates)."""
    trainer = _port_trainer(emx_steps)
    state = trainer.new_state()
    state.pred_avg = state.pred_avg.double()
    state.pred_avg_real = state.pred_avg_real.double()
    batch = torch.from_numpy(emx_steps["data"])
    for ref in emx_steps["steps"]:
        state, m = trainer.step_fn(state, batch, *ref["do"],
                                   draws=ref["draws"])
        for k, v in ref["metrics"].items():
            assert float(m[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
        assert float(state.pred_avg) == pytest.approx(ref["pred_avg"][0],
                                                      abs=1e-7)
        assert float(state.pred_avg_real) == pytest.approx(
            ref["pred_avg"][1], abs=1e-7)
        for net, key in ((state.gen, "gen"), (state.disc, "disc")):
            got = to_flax_params(net)[0]
            assert set(got) == set(ref[key])
            for k, v in ref[key].items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{key} {k}")
    assert state.step == 2


def test_gated_step_freezes_the_other_net(emx_steps):
    """A generator step leaves the discriminator's parameters and its
    whole optimizer state (Adam's count included) as they were, and the
    reverse; both losses and gradients are computed either way."""
    trainer = _port_trainer(emx_steps, dtype=torch.float32)
    state = trainer.new_state()
    batch = torch.from_numpy(emx_steps["data"])
    disc0 = [p.detach().clone() for p in state.disc.parameters()]
    state, m = trainer.step_fn(state, batch, True, False)
    assert all(torch.equal(a, b)
               for a, b in zip(disc0, state.disc.parameters()))
    assert not state.disc_opt.state
    assert np.isfinite(float(m["disc_loss"]))
    gen1 = [p.detach().clone() for p in state.gen.parameters()]
    counts = [float(s["step"]) for s in state.gen_opt.state.values()]
    state, _ = trainer.step_fn(state, batch, False, True)
    assert all(torch.equal(a, b)
               for a, b in zip(gen1, state.gen.parameters()))
    assert [float(s["step"]) for s in state.gen_opt.state.values()] == counts
    assert all(float(s["step"]) == 1
               for s in state.disc_opt.state.values())


def test_flip_adapt_and_clip_formulas():
    """emx's formulas (gan-infilling-100.py:1726-1734) and optax's
    clip_by_global_norm (scaled only at or above the limit)."""
    assert float(_flip_prob(torch.tensor(0.0))) == pytest.approx(0.01)
    assert float(_flip_prob(torch.tensor(1.0))) == pytest.approx(0.0)
    assert float(_adapt_rate(torch.tensor(0.5))) == pytest.approx(
        10 * np.exp(-0.5) * (1 - np.exp(-0.25)), rel=1e-6)
    g = [torch.tensor([3.0, 4.0])]
    assert float(clip_by_global_norm_(g, 10.0)) == 5.0
    assert g[0].tolist() == [3.0, 4.0]
    clip_by_global_norm_(g, 1.0)
    np.testing.assert_allclose(g[0].numpy(), [0.6, 0.8], rtol=1e-6)


# ---------------------------------------------------------------------------
# The host loop on scripted D(fake) sequences, emx's against the port's.

class _Pipe:
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        while True:
            yield np.zeros((self.n, 2, 2), np.float32)

    def state_dict(self):
        return {"epoch": 0, "index": 0}


def _metric_row(d_fake, d_real):
    return {"gen_loss": 1.0, "disc_loss": 1.0, "d_fake": d_fake,
            "d_fake_after": d_fake, "d_real": d_real, "mse": 0.1}


def _emx_calls(cfg_kw, d_fake, d_real, rollback_to, steps, start=0):
    calls = []
    tr = FlaxGANTrainer(None, None, FlaxGANConfig(log_every=0, **cfg_kw),
                        mesh=make_mesh())

    def stub(s, batch, do_gen, do_disc):
        i = int(s.step)
        calls.append((i, bool(do_gen), bool(do_disc)))
        row = _metric_row(d_fake[i], d_real[i])
        return s.replace(step=s.step + 1), {k: jnp.asarray(v)
                                            for k, v in row.items()}

    class Ckpt:
        def rollback(self, s):
            return s.replace(step=jnp.asarray(rollback_to, jnp.int32)), None

        def save(self, *a, **k):
            pass

    tr._step_fn = stub
    zero = jnp.zeros(())
    state = FlaxGANState(step=jnp.asarray(start, jnp.int32), gen_params={},
                         gen_stats={}, disc_params={}, disc_stats={},
                         gen_opt=(), disc_opt=(), rng=zero, pred_avg=zero,
                         pred_avg_real=zero)
    tr.fit(state, _Pipe(len(jax.devices())), steps,
           checkpointer=Ckpt() if rollback_to is not None else None)
    return calls


def _port_calls(cfg_kw, d_fake, d_real, rollback_to, steps, start=0):
    calls = []
    tr = GANTrainer(None, None, GANConfig(log_every=0, **cfg_kw))

    def stub(s, batch, do_gen, do_disc):
        calls.append((s.step, bool(do_gen), bool(do_disc)))
        row = _metric_row(d_fake[s.step], d_real[s.step])
        s.step += 1
        return s, {k: torch.tensor(v) for k, v in row.items()}

    class Ckpt:
        def rollback(self, s):
            s.step = rollback_to
            return s, None

        def save(self, *a, **k):
            pass

    tr.step_fn = stub
    state = type("S", (), {"step": start})()
    tr.fit(state, _Pipe(1), steps,
           checkpointer=Ckpt() if rollback_to is not None else None)
    return calls, tr.stats


SCRIPTS = {
    # (GANConfig fields, d_fake by step, d_real by step, rollback target)
    "bands": ({}, [0.1, 0.1, 0.9, 0.9, 0.5, 0.5, 0.2, 0.8, 0.5, 0.1, 0.9,
                   0.4], None, None),
    "window4": ({"trainee_switch_skip_n": 4}, [0.9] * 4 + [0.1] * 4
                + [0.5] * 4, None, None),
    "forced": ({"max_num_since_change": 3}, [0.1] * 12, None, None),
    "forced_windows": ({"max_num_since_change": 2,
                        "trainee_switch_skip_n": 2}, [0.9] * 12, None, None),
    "starved": ({"max_num_since_change": 0}, [0.1] * 12, None, None),
    "collapse": ({}, [0.2] * 11 + [0.5] * 3 + [0.2] * 10,
                 [0.8] * 11 + [0.5] * 3 + [0.8] * 10, 9),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_fit_schedule_matches_emx(name):
    """The trainee at every step, the steps the loop runs and the
    rollbacks (the loop count is fixed when fit starts, and a rollback
    skips that step's switching) as emx's fit has them."""
    cfg_kw, d_fake, d_real, rollback_to = SCRIPTS[name]
    n = len(d_fake)
    d_real = d_real or [0.9] * n
    steps = n if rollback_to is None else 14
    ref = _emx_calls(cfg_kw, d_fake, d_real, rollback_to, steps)
    got, stats = _port_calls(cfg_kw, d_fake, d_real, rollback_to, steps)
    assert got == ref
    if name == "collapse":
        assert stats["rollbacks"] >= 1
    if name.startswith("forced"):
        assert stats["forced_switches"] >= 1


def test_checkpoint_resume_equals_uninterrupted(emx_steps, tmp_path):
    """fit to step 2 with a checkpoint there, then to 4: a fresh trainer
    restored from the checkpoint (both nets, both optimizers, the EMAs,
    the step, the pipeline cursor) ends where the uninterrupted run does,
    bit for bit; rollback restores the newest checkpoint."""
    from emx_torch.data import DeviceDataset, PipelineConfig

    data = synthetic_micrographs(8, SIZE, seed=5)

    def run(ckpt_dir, resume):
        trainer = _port_trainer(emx_steps, dtype=torch.float32,
                                ckpt_every_steps=2)
        state = trainer.new_state()
        pipe = DeviceDataset(data, PipelineConfig(batch_size=B,
                                                  crop_size=SIZE),
                             device=CPU)
        ckpt = Checkpointer(str(ckpt_dir))
        if resume:
            state, cursor = ckpt.restore(state, step=2)
            pipe.load_state_dict(cursor)
            assert state.step == 2 and cursor == {"epoch": 0, "index": 4}
        else:
            state = trainer.fit(state, pipe, 2, checkpointer=ckpt)
        return trainer.fit(state, pipe, 4, checkpointer=ckpt)

    whole = run(tmp_path / "a", False)
    resumed = run(tmp_path / "a", True)
    for a, b in ((whole.gen, resumed.gen), (whole.disc, resumed.disc)):
        for (k, x), (_, y) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            assert torch.equal(x, y), k
    assert float(whole.pred_avg) == float(resumed.pred_avg)
    assert resumed.step == 4
    ckpt = Checkpointer(str(tmp_path / "a"))
    assert ckpt.latest_step() == 4
    back, _ = ckpt.rollback(resumed)
    assert back.step == 4


@pytest.mark.slow
def test_committed_gan_state_scores_as_emx(tmp_path):
    """The port and emx, both on the CPU, score the committed 125000-step
    state (docs/runs/gan_quality_300k/gan_state.npz: scale 0.5, 256^2,
    coverage 1/64) within 0.02 dB of each other on every row (eval only:
    steps equal to the state's step). Several minutes (emx compiles the
    scale-0.5 nets)."""
    from emx.bench import gan_quality as flax_gan_quality
    from emx_torch.bench import gan_quality

    state = "docs/runs/gan_quality_300k/gan_state.npz"
    kw = dict(steps=125000, batch=8, size=256, scale=0.5, mse_weight=100.0,
              init_from=state, coverage=64)
    ref = flax_gan_quality.main(str(tmp_path / "emx"), **kw)
    got = gan_quality.main(str(tmp_path / "port"), device="cpu", **kw)
    assert got["steps"] == ref["steps"] == 125000
    for k, v in ref["all"].items():
        assert got["all_exact"][k] == pytest.approx(v, abs=0.02), k
    assert got["identity_exact"] == pytest.approx(
        ref["identity_psnr_masked"], abs=0.02)

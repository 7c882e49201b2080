"""The port's training engine against emx's on the CPU.

The train step of a tiny BatchNorm Denoiser (nesterov, 3 steps) is held
against emx's `Trainer.step_fn` on the same flax-initialised parameters
and the same fixed (inputs, targets) batch; the optimizer variants
(adam, grad_accum, clipping, weight decay) against emx on a two-layer
dense model that compiles in seconds, as tests/test_nn_train.py does.
The JAX compiles are few and shared through module fixtures: one jitted
Denoiser init, one Denoiser train step, one dense step per variant.
Comparisons of the port against itself (remat, resume, hot reload,
metrics, the dataset) need no JAX."""

import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from emx.data.pipeline import synthetic_micrographs as flax_synthetic
from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.train import TrainConfig as FlaxTrainConfig
from emx.train import Trainer as FlaxTrainer
from emx.train.engine import TrainState as FlaxTrainState
from emx_torch.data import (DeviceDataset, PipelineConfig, denoiser_example,
                            synthetic_micrographs)
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.nn.blocks import BatchNorm
from emx_torch.nn.init import init_parameters
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.train import (Checkpointer, TrainConfig, Trainer, TrainState,
                             make_optimizer)
from emx_torch.train import engine
from emx_torch.utils.rng import fold_in


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers,
    and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


CPU = "cpu"
BN_KW = dict(norm="batch")   # DenoiserConfig.tiny(): one middle block


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _flax_state(trainer, variables):
    params = variables["params"]
    return FlaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=variables.get("batch_stats", {}),
        opt_state=trainer.optimizer.init(params),
        rng=jax.random.key_data(jax.random.key(0)))


@pytest.fixture(scope="module")
def flax_bn():
    """The tiny BatchNorm Denoiser: flax variables from one jitted init
    (float32), a fixed batch, and emx's metrics and state after 3 nesterov
    steps computed in float64 (see test_denoiser_step_matches_emx)."""
    model = FlaxDenoiser(dataclasses.replace(FlaxConfig.tiny(), **BN_KW))
    rng = np.random.default_rng(0)
    x = rng.random((4, 64, 64)).astype(np.float32)
    t = (0.8 * x + 0.1).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, a: model.init(k, a, train=False))(jax.random.key(1),
                                                    jnp.asarray(x)))
    metrics = []
    with jax.enable_x64():
        model64 = FlaxDenoiser(dataclasses.replace(
            FlaxConfig.tiny(), **BN_KW, dtype=jnp.float64))
        tr = FlaxTrainer(model64, FlaxTrainConfig(learning_rate=1e-2,
                                                  log_every=0),
                         example_fn=None)
        state = _flax_state(tr, variables)
        for _ in range(3):
            state, m = tr.step_fn(state, (x, t))
            metrics.append({k: float(v) for k, v in m.items()})
        params, stats = _flat(state.params), _flat(state.batch_stats)
    return {"variables": variables, "x": x, "t": t, "metrics": metrics,
            "params": params, "batch_stats": stats}


def _port_bn(variables, **kw):
    model = Denoiser(dataclasses.replace(DenoiserConfig.tiny(), **BN_KW, **kw),
                     device=CPU)
    return load_flax_params(model, _flat(variables["params"]),
                            _flat(variables["batch_stats"]))


def _fresh_state(model, trainer):
    """A TrainState around `model` as it stands (no re-initialisation)."""
    return TrainState(0, model, make_optimizer(trainer.cfg,
                                               model.parameters()))


def test_denoiser_step_matches_emx(flax_bn):
    """Loss, mse and grad_norm per step, and the parameters and running
    statistics after 3 steps, with the parameters in float32 and the
    forward and backward in float64 on both sides (flax dtype float64
    under jax.enable_x64, the port's dtype torch.float64). In float32,
    flax's one-pass BatchNorm reductions lose up to 2e-4 of the
    normalised output at these activations' mean-to-spread ratios (the
    port's, up to 1e-5; measured against float64), and three momentum
    steps amplify that to percent-level grad_norm differences; in float64
    both agree to the float32 rounding of the parameters: rtol 1e-5 on
    the metrics, atol 1e-6 with rtol 1e-5 on the parameters and stats."""
    model = _port_bn(flax_bn["variables"], dtype=torch.float64)
    trainer = Trainer(model, TrainConfig(learning_rate=1e-2, log_every=0))
    state = _fresh_state(model, trainer)
    batch = (torch.from_numpy(flax_bn["x"]), torch.from_numpy(flax_bn["t"]))
    for ref in flax_bn["metrics"]:
        state, m = trainer.step_fn(state, batch)
        for k, v in ref.items():
            assert float(m[k]) == pytest.approx(v, rel=1e-5), k
    assert state.step == 3
    params, stats = to_flax_params(model)
    assert set(params) == set(flax_bn["params"])
    assert set(stats) == set(flax_bn["batch_stats"])
    for got, ref in ((params, flax_bn["params"]),
                     (stats, flax_bn["batch_stats"])):
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    # The running statistics moved: 0.99 * running + 0.01 * batch, thrice.
    init_stats = _flat(flax_bn["variables"]["batch_stats"])
    assert any(not np.allclose(stats[k], init_stats[k]) for k in stats)


def test_batchnorm_statistics_against_float64():
    """Why the step parity runs in float64: on channels with mean 0.5 and
    spread 0.1, flax's float32 one-pass statistics (XLA's CPU reductions)
    move the normalised output by more than 1e-4 from the float64 value,
    the port's (torch's reductions, same formula) by less than 2e-5."""
    rng = np.random.default_rng(0)
    x = (0.5 + 0.1 * rng.standard_normal((4, 32, 32, 8))).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    variables = bn.init(jax.random.key(0), x)
    flax_y, _ = bn.apply(variables, x, mutable=["batch_stats"])
    port_y = BatchNorm(8, torch.float32)(torch.from_numpy(x), train=True)
    x64 = x.astype(np.float64)
    mean = x64.mean((0, 1, 2))
    exact = (x64 - mean) / np.sqrt((x64 ** 2).mean((0, 1, 2)) - mean ** 2
                                   + 1e-3)
    assert np.abs(np.asarray(flax_y) - exact).max() > 1e-4
    assert np.abs(port_y.detach().numpy() - exact).max() < 2e-5


def _one_step(model, x, t):
    trainer = Trainer(model, TrainConfig(learning_rate=1e-2, log_every=0))
    state, m = trainer.step_fn(_fresh_state(model, trainer), (x, t))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return m, grads, {n: b.clone() for n, b in model.named_buffers()}


def test_remat_middle_changes_nothing(flax_bn):
    """Rematerialising the middle block recomputes its forward in the
    backward pass; loss, gradients and running statistics stay the same,
    and BatchNorm inside it updates its statistics once, not twice."""
    x, t = torch.from_numpy(flax_bn["x"]), torch.from_numpy(flax_bn["t"])
    plain = _one_step(_port_bn(flax_bn["variables"]), x, t)
    remat = _one_step(_port_bn(flax_bn["variables"], remat_middle=True), x, t)
    assert float(plain[0]["loss"]) == float(remat[0]["loss"])
    for a, b in zip(plain[1:], remat[1:]):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7,
                                       msg=k)
    mid = "XceptionMiddleBlock_0.SepConvBlock_0.Norm_0.BatchNorm_0.mean"
    assert not torch.equal(remat[2][mid], torch.zeros_like(remat[2][mid]))


def test_init_matches_flax_distributions(flax_bn):
    """The port's init (a torch.Generator; the card has no JAX) against
    flax's model.init on the same config: the same keys and shapes, zero
    biases, unit norm scales, and kernels from lecun_normal: a normal
    truncated at 2 standard deviations of sqrt(1/fan_in)/0.8796. Per
    tensor of 500 or more values, the std within 12% of that (the
    sampling error is below 6% there); every |w| within 2 sigma."""
    model = init_parameters(
        Denoiser(dataclasses.replace(DenoiserConfig.tiny(), **BN_KW),
                 device=CPU), torch.Generator().manual_seed(0))
    params, stats = to_flax_params(model)
    ref = _flat(flax_bn["variables"]["params"])
    ref_stats = _flat(flax_bn["variables"]["batch_stats"])
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in ref.items()}
    for k in ref_stats:
        np.testing.assert_array_equal(stats[k], ref_stats[k])
    checked = 0
    for k, ref_v in ref.items():
        got = params[k]
        if not k.endswith("kernel"):
            np.testing.assert_array_equal(got, ref_v, err_msg=k)
            continue
        fan_in = int(np.prod(ref_v.shape[:-1]))
        sigma = np.sqrt(1.0 / fan_in) / 0.87962566
        for w in (got, ref_v):
            assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6), k
            if w.size >= 500:
                assert abs(w.std() / sigma - 0.87962566) < 0.12 * 0.88, k
        checked += got.size >= 500
    assert checked >= 10


class _FlaxLinear(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        b, h, w = x.shape
        y = fnn.Dense(16)(x.reshape(b, -1))
        y = fnn.Dense(h * w)(y)
        return y.reshape(b, h, w)


class _Linear(torch.nn.Module):
    """The port's twin of the dense model (flax Dense = x @ kernel + b)."""

    def __init__(self, hw):
        super().__init__()
        self.l0, self.l1 = torch.nn.Linear(hw, 16), torch.nn.Linear(16, hw)

    def forward(self, x, train=False):
        b, h, w = x.shape
        return self.l1(self.l0(x.reshape(b, -1))).reshape(b, h, w)

    def load(self, params):
        with torch.no_grad():
            for mod, name in ((self.l0, "Dense_0"), (self.l1, "Dense_1")):
                mod.weight.copy_(torch.from_numpy(
                    np.asarray(params[name]["kernel"]).T.copy()))
                mod.bias.copy_(torch.from_numpy(
                    np.array(params[name]["bias"])))
        return self


VARIANTS = {
    "nesterov": dict(optimizer="nesterov", learning_rate=0.05),
    "adam": dict(optimizer="adam", learning_rate=0.01),
    "grad_accum2": dict(optimizer="nesterov", learning_rate=0.05,
                        grad_accum=2),
    "clip_hit": dict(optimizer="nesterov", learning_rate=0.05,
                     grad_clip_norm=0.5),
    "clip_not_hit": dict(optimizer="adam", learning_rate=0.01,
                         grad_clip_norm=1e6),
    "weight_decay": dict(optimizer="adam", learning_rate=0.01,
                         weight_decay=0.1),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_optimizer_variants_match_emx(variant):
    """3 steps of each optimizer setting on the dense model, against emx:
    loss, mse and grad_norm per step (float32 sums in other orders: rtol
    1e-5), and the parameters after: rtol 1e-5 and atol 1e-5, a
    thousandth of a step, since adam's m / (sqrt(v) + 1e-8) turns a
    gradient near 1e-8 into a step whose size rests on its rounding
    (one of 4,096 weights moved 2.6e-6 apart)."""
    kw = VARIANTS[variant]
    data = flax_synthetic(8, 16, seed=5)
    x, t = data, (data * 0.5 + 0.1).astype(np.float32)
    model = _FlaxLinear()
    tr = FlaxTrainer(model, FlaxTrainConfig(log_every=0, seed=1, **kw),
                     example_fn=None)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.key(1), jnp.asarray(x)))
    state = _flax_state(tr, variables)
    port = _Linear(256).load(variables["params"])
    ptr = Trainer(port, TrainConfig(log_every=0, seed=1, **kw))
    pstate = _fresh_state(port, ptr)
    for _ in range(3):
        state, m = tr.step_fn(state, (x, t))
        pstate, pm = ptr.step_fn(pstate, (torch.from_numpy(x),
                                          torch.from_numpy(t)))
        for k in ("loss", "mse", "grad_norm"):
            assert float(pm[k]) == pytest.approx(float(m[k]), rel=1e-5), k
    if variant == "clip_hit":
        assert float(m["grad_norm"]) > 0.5
    ref = state.params
    np.testing.assert_allclose(port.l0.weight.detach().numpy(),
                               np.asarray(ref["Dense_0"]["kernel"]).T,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.l1.bias.detach().numpy(),
                               np.asarray(ref["Dense_1"]["bias"]),
                               rtol=1e-5, atol=1e-5)


def test_unported_options_raise(tmp_path):
    """emx's four options that raised in the port before run now:
    profile_dir writes a Chrome trace of the chosen steps, sample_every
    writes emx's input/truth/output TIFFs, a DoseProbe trains and its
    eval hook updates the CDF, and steps_per_launch > 1 builds a CUDA
    graph (on the CPU it says that it needs the card). The probe refuses
    steps_per_launch > 1, as emx's does."""
    from emx_torch.io.tiff import read_tiff
    from emx_torch.train.dose_probe import DoseProbe

    tr, state, data = _tiny_fit_setup(
        tmp_path, "opts", profile_dir=str(tmp_path / "trace"),
        profile_start_step=1, profile_num_steps=2, sample_every=2)
    tr.fit(state, data, 4)
    traces = os.listdir(tmp_path / "trace")
    assert traces == ["trace_step1.json"]
    with open(tmp_path / "trace" / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    samples = sorted(os.listdir(os.path.join(tr.cfg.model_dir, "samples")))
    assert samples == sorted(f"{s}_{n}.tif" for s in (2, 4)
                             for n in ("input", "truth", "output"))
    img = read_tiff(os.path.join(tr.cfg.model_dir, "samples",
                                 "4_output.tif"))
    assert img.shape == (32, 32) and 0 <= img.min() <= img.max() <= 1

    probe = DoseProbe(num_bins=4)
    model = Denoiser(dataclasses.replace(DenoiserConfig.tiny(), **BN_KW),
                     device=CPU)
    ptr = Trainer(model, TrainConfig(log_every=1, seed=2,
                                     model_dir=str(tmp_path / "probe")),
                  example_fn=probe.example_fn, probe=probe)
    pstate = ptr.init()
    val = synthetic_micrographs(2, 32, seed=7)
    ptr.fit(pstate, data, 4, eval_fn=probe.make_eval_hook(ptr, val),
            eval_every=2)
    assert probe.prev_losses is not None and len(probe.prev_losses) == 4
    assert probe.cum_probs[-1] == pytest.approx(1.0)

    gtr = Trainer(_Linear(16), TrainConfig(steps_per_launch=2),
                  example_fn=denoiser_example)
    with pytest.raises(RuntimeError, match="CUDA card"):
        gtr.fit(_fresh_state(gtr.model, gtr), data, 2)
    with pytest.raises(ValueError, match="steps_per_launch"):
        Trainer(model, TrainConfig(steps_per_launch=2), probe=probe,
                example_fn=probe.example_fn)
    with pytest.raises(ValueError, match="two halves"):
        Trainer(model, TrainConfig(steps_per_launch=2),
                example_fn=lambda seed, x: (x, x))
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(TrainConfig(optimizer="lamb"), model.parameters())


def test_grad_accum_must_split_the_batch():
    model = _Linear(16)
    trainer = Trainer(model, TrainConfig(grad_accum=3, log_every=0))
    x = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError, match="grad_accum=3"):
        trainer.step_fn(_fresh_state(model, trainer), (x, x))


# -- fit, checkpoints, hot reload, metrics: the port against itself -----

def _tiny_fit_setup(tmp_path, name, **cfg_kw):
    model = Denoiser(dataclasses.replace(DenoiserConfig.tiny(), **BN_KW,
                                         remat_middle=True), device=CPU)
    cfg = TrainConfig(log_every=1, seed=3, model_dir=str(tmp_path / name),
                      **cfg_kw)
    trainer = Trainer(model, cfg, example_fn=denoiser_example)
    data = DeviceDataset(synthetic_micrographs(6, 32, seed=1),
                         PipelineConfig(batch_size=2, crop_size=32, seed=4),
                         device=CPU)
    return trainer, trainer.init(), data


def test_checkpoint_resume_is_exact(tmp_path):
    """4 steps straight against 2 steps, a save, a fresh Trainer, a
    restore and 2 more: identical parameters, statistics and optimizer
    buffers on the CPU (the step's randomness and the data order are
    seeded from the step and the cursor). max_to_keep is honoured."""
    tr, state, data = _tiny_fit_setup(tmp_path, "straight")
    tr.fit(state, data, 4)

    tr2, state2, data2 = _tiny_fit_setup(tmp_path, "resumed",
                                         ckpt_every_steps=1)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    tr2.fit(state2, data2, 2, checkpointer=ckpt)
    assert ckpt.all_steps() == [1, 2] and ckpt.latest_step() == 2

    tr3, state3, data3 = _tiny_fit_setup(tmp_path, "fresh",
                                         ckpt_every_steps=1)
    state3, pipe = ckpt.restore(state3)
    assert state3.step == 2 and pipe == {"epoch": 0, "index": 4}
    data3.load_state_dict(pipe)
    tr3.fit(state3, data3, 4, checkpointer=ckpt)
    assert ckpt.all_steps() == [3, 4]
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              state3.model.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.state.values(),
                    state3.optimizer.state.values()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(state3)


def test_lr_hot_reload_and_metrics_jsonl(tmp_path):
    """learning_rate.txt written between steps sets the rate of the next
    step: with 0 the parameters stop moving. metrics.jsonl has a line
    per logged step with loss, mse and grad_norm."""
    tr, state, data = _tiny_fit_setup(tmp_path, "lr")
    snaps = {}

    def snapshot(st, step):
        snaps[step] = [p.detach().clone() for p in st.model.parameters()]

    tr.fit(state, data, 1, eval_fn=snapshot, eval_every=1)
    with open(os.path.join(tr.cfg.model_dir, "learning_rate.txt"), "w") as f:
        f.write("0.0\n")
    tr.fit(state, data, 3, eval_fn=snapshot, eval_every=1)
    assert state.optimizer.param_groups[0]["lr"] == 0.0
    moved = any(not torch.equal(a, b) for a, b in zip(snaps[1], snaps[2]))
    assert moved   # step 2 ran at the old rate; the file was read after it
    assert all(torch.equal(a, b) for a, b in zip(snaps[2], snaps[3]))

    with open(os.path.join(tr.cfg.model_dir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["step"] for ln in lines] == [1, 2, 3]
    for ln in lines:
        assert {"loss", "mse", "grad_norm"} <= set(ln)
        assert np.isfinite([ln["loss"], ln["mse"], ln["grad_norm"]]).all()
    assert os.path.exists(os.path.join(tr.cfg.model_dir, "log.txt"))


def test_device_dataset_batches_and_resume():
    """Mirrors tests/test_data.py:165 for the port's DeviceDataset."""
    data = synthetic_micrographs(12, 32)
    cfg = PipelineConfig(batch_size=4, crop_size=32, seed=2)
    it = iter(DeviceDataset(data, cfg, device=CPU))
    b1 = [next(it) for _ in range(4)]   # crosses an epoch
    assert all(tuple(b.shape) == (4, 32, 32) for b in b1)
    epoch0 = torch.cat(b1[:3]).numpy()
    assert sorted(map(bytes, epoch0)) == sorted(map(bytes, data))

    ds2 = DeviceDataset(data, cfg, device=CPU)
    assert torch.equal(next(iter(ds2)), b1[0])   # same seed, same order

    ds3 = DeviceDataset(data, cfg, device=CPU)
    it3 = iter(ds3)
    next(it3), next(it3)
    ds4 = DeviceDataset(data, cfg, device=CPU)
    ds4.load_state_dict(ds3.state_dict())
    assert torch.equal(next(iter(ds4)), b1[2])

    with pytest.raises(ValueError, match="crop_size"):
        DeviceDataset(data, PipelineConfig(crop_size=16), device=CPU)
    with pytest.raises(ValueError, match="batch_size"):
        DeviceDataset(data, PipelineConfig(batch_size=13, crop_size=32),
                      device=CPU)
    # An integer corpus is cast on the device.
    ints = DeviceDataset((data * 255).astype(np.uint8), cfg, device=CPU)
    assert ints.data.dtype == torch.float32


def test_synthetic_micrographs_bit_identical():
    np.testing.assert_array_equal(synthetic_micrographs(3, 48, seed=9),
                                  flax_synthetic(3, 48, seed=9))


# -- steps_per_launch: the graph's control flow on the CPU ---------------

class _EagerGraph:
    """StepGraph's interface without a card: each replay runs its K steps
    eagerly from the batches and draws staged for it, as the captured
    graph does from its pinned buffers."""

    state_key = staticmethod(engine.StepGraph.state_key)
    seeds: list = []

    def __init__(self, trainer, state, batches, seeds):
        self.trainer, self.state = trainer, state
        self.k2_per_replay, self.capture_s = len(batches), 0.0
        self.key = self.state_key(state)
        _EagerGraph.seeds += seeds
        self.stage(batches, [trainer.example_fn.draws(
            s, batches[0].shape[0], "cpu") for s in seeds])

    def stage(self, batches, draws):
        self.batches, self.draws = [torch.as_tensor(b) for b in batches], draws

    def replay(self):
        rows = []
        for b, d in zip(self.batches, self.draws):
            x, t = self.trainer.example_fn.apply(d, b.float())
            m = self.trainer._update(self.state, x, t)
            rows.append(torch.stack([m[k] for k in engine.METRICS]))
        self.metrics = torch.stack(rows)


@pytest.fixture
def eager_graph(monkeypatch):
    monkeypatch.setattr(engine, "StepGraph", _EagerGraph)
    _EagerGraph.seeds = []
    return _EagerGraph


def test_steps_per_launch_draws_what_eager_draws(tmp_path, eager_graph):
    """The per-step seeds of a steps_per_launch run are the eager run's
    (fold_in(seed, 1, step)), and K steps a launch give the eager run's
    parameters and BatchNorm statistics, bit for bit on the CPU."""
    seen = []
    tr, state, data = _tiny_fit_setup(tmp_path, "eager")
    orig = tr.step_seed
    tr.step_seed = lambda step: seen.append(orig(step)) or orig(step)
    tr.fit(state, data, 6)
    gtr, gstate, gdata = _tiny_fit_setup(tmp_path, "graph",
                                         steps_per_launch=3)
    gtr.fit(gstate, gdata, 6)
    assert eager_graph.seeds == seen == [fold_in(3, 1, s) for s in range(6)]
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              gstate.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert gtr.graph_stats["replays"] == 2
    assert gtr.graph_stats["k2_replayed"] == 6
    with open(os.path.join(gtr.cfg.model_dir, "metrics.jsonl")) as f:
        assert [json.loads(ln)["step"] for ln in f] == [3, 6]


def test_fit_overshoots_num_steps_as_emx_does(tmp_path, eager_graph):
    """7 steps in launches of 3 run 9, in emx and in the port."""
    from emx.data.degrade import denoiser_example as flax_example

    data = flax_synthetic(16, 16, seed=5)
    model = _FlaxLinear()
    tr = FlaxTrainer(model, FlaxTrainConfig(log_every=0, seed=1,
                                            steps_per_launch=3),
                     example_fn=flax_example)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.key(1), jnp.asarray(data[:8])))
    state = tr.fit(_flax_state(tr, variables),
                   _Batches(data[:8]), 7)
    assert int(state.step) == 9
    gtr, gstate, gdata = _tiny_fit_setup(tmp_path, "over",
                                         steps_per_launch=3)
    gtr.fit(gstate, gdata, 7)
    assert gstate.step == 9


class _Batches:
    """An endless pipeline of one batch."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        while True:
            yield self.batch

    def state_dict(self):
        return {}


def test_probe_refuses_steps_per_launch_as_emx_does():
    from emx.train.dose_probe import DoseProbe as FlaxProbe
    from emx_torch.train.dose_probe import DoseProbe

    with pytest.raises(ValueError, match="steps_per_launch"):
        FlaxTrainer(_FlaxLinear(), FlaxTrainConfig(steps_per_launch=2),
                    example_fn=FlaxProbe(4).example_fn, probe=FlaxProbe(4))
    with pytest.raises(ValueError, match="steps_per_launch"):
        Trainer(_Linear(16), TrainConfig(steps_per_launch=2),
                example_fn=DoseProbe(4).example_fn, probe=DoseProbe(4))


def test_graph_run_resumes_the_same_cursor(tmp_path, eager_graph):
    """Launches of 2 steps, checkpoints every 2: a run restored from
    step 4 ends where an uninterrupted run to 8 ends, its cursor
    included, and the restore recaptures (the optimizer's tensors were
    replaced)."""
    tr, state, data = _tiny_fit_setup(tmp_path, "whole", steps_per_launch=2)
    tr.fit(state, data, 8)
    tr2, state2, data2 = _tiny_fit_setup(tmp_path, "first",
                                         steps_per_launch=2,
                                         ckpt_every_steps=2)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    tr2.fit(state2, data2, 4, checkpointer=ckpt)
    assert ckpt.all_steps() == [2, 4]
    tr3, state3, data3 = _tiny_fit_setup(tmp_path, "resumed",
                                         steps_per_launch=2)
    tr3.fit(state3, data3, 2)        # a graph of the fresh state
    assert tr3.graph_stats["captures"] == 1
    state3, cursor = ckpt.restore(state3)
    assert state3.step == 4 and cursor == data2.state_dict() == {
        "epoch": 1, "index": 2}
    data3.load_state_dict(cursor)
    tr3.fit(state3, data3, 8)
    assert tr3.graph_stats["captures"] == 2
    assert data3.state_dict() == data.state_dict()
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              state3.model.state_dict().items()):
        assert torch.equal(a, b), k

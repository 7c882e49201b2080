"""The training engine (port of emx/train/engine.py).

One step: the example synthesis (the batch degrade runs on the fused
Poisson kernel), forward in training mode, loss, backward, gradient
accumulation over microbatches, clipping and the optimizer update, all
on the batch's device. PyTorch runs eagerly, so the step is a method,
not a compiled program, and it updates the model and the optimizer in
place: `TrainState` holds them and the step count.

Where emx's optax chain and the port's optimizers meet:
  * nesterov: optax `sgd(momentum, nesterov=True)` (its `trace`) is
    torch `SGD(nesterov=True, dampening=0)`;
  * adam: optax `adam(b1)` with b2 0.999 and eps 1e-8 added after the
    square root of the bias-corrected second moment, as torch's Adam
    adds it; on a card `capturable=True` with the learning rate a device
    tensor, so that a CUDA graph reads it;
  * `grad_clip_norm`: optax's `clip_by_global_norm`, g * max / |g| only
    where |g| >= max (not torch's clip_grad_norm_, which adds 1e-6);
  * `weight_decay`: 0.5 * wd * sum(p^2) over every parameter is added to
    the loss, as emx does, so `grad_norm` matches.

The step's randomness is seeded from (TrainConfig.seed, step): a resumed
run draws what an uninterrupted one draws. With an example function in
two halves (emx_torch.data.degrade.SplitExample) a graph's K steps draw
before the replay, as eager steps draw, and the draws reach the graph
through pinned buffers.

`steps_per_launch` K > 1 is emx's lax.scan of K optimizer steps in one
XLA program; on the card it is one CUDA graph of K complete steps
(`StepGraph`), captured once and replayed: each replay copies K batches
and K steps' draws in from pinned buffers and runs K steps of example
synthesis (K2 included), forward, backward, clipping and the update,
with one host launch. `fit` may overshoot `num_steps` to the next
multiple of K, as emx's does. What a captured step reads from the host
is frozen at capture, so everything that changes per step comes from
device memory: the draws (K2 reads its Philox key from a device
tensor), the batches, and Adam's learning rate; SGD's update reads its
learning rate as a host number, so a new learning rate recaptures, as
does any replaced model or optimizer tensor (a checkpoint restore).

The learning rate lives in the optimizer's param groups, so the
`learning_rate.txt` hot reload sets it there (in place for a tensor).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from emx_torch.nn.init import init_parameters
from emx_torch.train.losses import huberised_mse
from emx_torch.utils.config import Config, config_field, watch_file
from emx_torch.utils.metrics import MetricsLogger, ThroughputMeter
from emx_torch.utils.rng import fold_in

METRICS = ("loss", "mse", "grad_norm")
# Eager steps run before a capture (then undone): the first takes the
# optimizer's first-step path, the second its steady one, so neither
# meets a lazy initialisation inside the capture.
WARMUP_STEPS = 2


@dataclasses.dataclass
class TrainState:
    """What a step changes: the step count, and (in place) the model's
    parameters and BatchNorm statistics and the optimizer's buffers."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


@dataclasses.dataclass
class TrainConfig(Config):
    learning_rate: float = config_field(1e-3, "initial learning rate")
    momentum: float = config_field(0.9, "SGD momentum (nesterov)")
    optimizer: str = config_field("nesterov", "nesterov|adam")
    adam_b1: float = config_field(0.9, "adam beta1")
    grad_clip_norm: float = config_field(0.0, "0 disables clipping")
    weight_decay: float = config_field(0.0, "L2 penalty")
    grad_accum: int = config_field(1, "microbatches per step (reference x5)")
    steps_per_launch: int = config_field(
        1, "optimizer steps in one launch (a CUDA graph of them on a card)")
    log_every: int = config_field(100, "steps between metric lines")
    sample_every: int = config_field(0, "dump input/truth/output TIFFs every N steps (0 off)")
    ckpt_every_steps: int = config_field(0, "0 disables step-periodic saves")
    ckpt_every_secs: float = config_field(0.0, "0 disables time-periodic saves")
    model_dir: str = config_field("", "checkpoint/log directory")
    seed: int = config_field(0, "training RNG seed")
    profile_dir: str = config_field(
        "", "write a torch.profiler Chrome trace here; empty disables")
    profile_start_step: int = config_field(10, "first traced step")
    profile_num_steps: int = config_field(5, "steps inside the trace")


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    params = list(params)
    if cfg.optimizer == "nesterov":
        return torch.optim.SGD(params, lr=cfg.learning_rate,
                               momentum=cfg.momentum, dampening=0.0,
                               nesterov=True)
    if cfg.optimizer == "adam":
        device = params[0].device if params else torch.device("cpu")
        if device.type == "cuda":
            # Capturable: the step count and the learning rate are device
            # tensors, which a CUDA graph reads on every replay.
            return torch.optim.Adam(
                params, lr=torch.tensor(cfg.learning_rate, device=device),
                betas=(cfg.adam_b1, 0.999), eps=1e-8, capturable=True)
        return torch.optim.Adam(params, lr=cfg.learning_rate,
                                betas=(cfg.adam_b1, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group, in place (a tensor
    learning rate is filled, so a CUDA graph that reads it sees it)."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def _pinned(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a step reads or writes in place: parameters, buffers,
    optimizer state, and tensor learning rates."""
    out = list(state.model.parameters()) + list(state.model.buffers())
    for st in state.optimizer.state.values():
        out += [v for v in st.values() if torch.is_tensor(v)]
    out += [g["lr"] for g in state.optimizer.param_groups
            if torch.is_tensor(g["lr"])]
    return out


class StepGraph:
    """K optimizer steps of `trainer` captured as one CUDA graph.

    Static inputs: a pinned (K, B, ...) batch buffer that the graph copies
    in (or, for batches already on the card, a device buffer filled
    before each replay) and pinned buffers of K steps' draws. Static
    outputs: a (K, 3) tensor of each step's loss, mse and grad_norm.
    `k2_per_replay` is the degrade kernel's launches inside one replay
    (the wrapper counts them once, at capture)."""

    def __init__(self, trainer: "Trainer", state: TrainState, batches,
                 seeds: list[int]):
        from emx_torch.ops.degrade_kernel import fused_poisson_degrade

        self.trainer = trainer
        self.k = len(batches)
        device = trainer.device
        if device.type != "cuda":
            raise RuntimeError("steps_per_launch > 1 runs a CUDA graph: it "
                               "needs the model on a CUDA card")
        first = batches[0]
        self.on_device = torch.is_tensor(first) and first.device == device
        shape = (self.k, *first.shape)
        dtype = first.dtype if torch.is_tensor(first) else \
            torch.from_numpy(np.asarray(first)).dtype
        self.batch = torch.empty(shape, dtype=dtype, device=device)
        self.host_batch = None if self.on_device else _pinned(shape, dtype)
        draws = [trainer.example_fn.draws(s, first.shape[0], device)
                 for s in seeds]
        self.host_draws = {k: _pinned((self.k, *v.shape), v.dtype)
                           for k, v in draws[0].items()}
        self.draws = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in self.host_draws.items()}
        self._done = torch.cuda.Event()
        self.stage(batches, draws)

        # Warm-up on a side stream, then undo it: the graph starts from
        # the state the caller gave.
        saved = {id(t): t.detach().clone() for t in _state_tensors(state)}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._copy_in()
            for i in range(WARMUP_STEPS):
                self._step(state, i % self.k)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t in _state_tensors(state):
                if id(t) in saved:
                    t.copy_(saved[id(t)])
                else:  # optimizer state the warm-up created: fresh is 0
                    t.zero_()
        del saved
        torch.cuda.synchronize(device)

        self.graph = torch.cuda.CUDAGraph()
        before = fused_poisson_degrade.launches
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            self._copy_in()
            self.metrics = torch.stack([self._step(state, i)
                                        for i in range(self.k)])
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.k2_per_replay = fused_poisson_degrade.launches - before
        self.key = self.state_key(state)

    @staticmethod
    def state_key(state: TrainState) -> tuple:
        """Changes when a tensor the graph reads is replaced, or when a
        host learning rate (baked into the graph) changes."""
        return (tuple(t.data_ptr() for t in _state_tensors(state)),
                tuple(g["lr"] for g in state.optimizer.param_groups
                      if not torch.is_tensor(g["lr"])))

    def _copy_in(self) -> None:
        if self.host_batch is not None:
            self.batch.copy_(self.host_batch, non_blocking=True)
        for k, v in self.host_draws.items():
            self.draws[k].copy_(v, non_blocking=True)

    def _step(self, state: TrainState, i: int) -> torch.Tensor:
        draws = {k: v[i] for k, v in self.draws.items()}
        inputs, targets = self.trainer.example_fn.apply(
            draws, self.batch[i].float())
        m = self.trainer._update(state, inputs, targets)
        return torch.stack([m[k] for k in METRICS])

    def stage(self, batches, draws: list[dict]) -> None:
        """Fill the static inputs for the next replay. The pinned buffers
        are rewritten only once the previous replay has read them."""
        self._done.synchronize()
        for i, b in enumerate(batches):
            if self.on_device:
                self.batch[i].copy_(b)
            else:
                self.host_batch[i].copy_(torch.from_numpy(np.asarray(b)))
        for i, d in enumerate(draws):
            for k, v in d.items():
                self.host_draws[k][i].copy_(v)

    def replay(self) -> None:
        self.graph.replay()
        self._done.record()


class Trainer:
    """Supervised trainer for (input, target)-style models.

    Args:
      model: a module on its device whose forward(x, train=...) returns
        predictions.
      example_fn: (seed, clean batch) -> (inputs, targets), run on the
        batch's device (see emx_torch.data.degrade); a SplitExample for
        `steps_per_launch` > 1. If None, batches must already be
        (inputs, targets) pairs.
      loss_fn: (pred, target) -> scalar; the reference's huberised MSE
        by default.
      probe: an emx_torch.train.dose_probe.DoseProbe whose example_fn is
        `example_fn`; it draws each step's doses from the probe's current
        CDF, so it refuses steps_per_launch > 1, as emx's does.
    """

    def __init__(self, model: nn.Module, cfg: TrainConfig,
                 example_fn: Callable | None = None,
                 loss_fn: Callable = huberised_mse, probe=None):
        if probe is not None and cfg.steps_per_launch > 1:
            raise ValueError("dose probing is incompatible with "
                             "steps_per_launch > 1")
        if cfg.steps_per_launch > 1 and not hasattr(example_fn, "draws"):
            raise ValueError("steps_per_launch > 1 needs an example_fn in "
                             "two halves (emx_torch.data.degrade."
                             "SplitExample)")
        self.model = model
        self.cfg = cfg
        self.example_fn = example_fn
        self.loss_fn = loss_fn
        self.graph: StepGraph | None = None
        # The metrics of fit's last step (device tensors, read on demand).
        self.last_metrics: dict | None = None
        # Graphs captured and replayed, and the degrade kernel's launches
        # inside the replays (the wrapper counts each captured launch once).
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0,
                            "k2_replayed": 0}
        self.logger = MetricsLogger(cfg.model_dir or None)
        self._lr_poll = (
            watch_file(os.path.join(cfg.model_dir, "learning_rate.txt"))
            if cfg.model_dir else lambda: None)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init(self, sample_input=None) -> TrainState:
        """Initialise the model's parameters from TrainConfig.seed (flax's
        default distributions, emx_torch.nn.init) and a fresh optimizer.
        `sample_input` is accepted for emx's signature: a torch module
        knows its shapes without one."""
        gen = torch.Generator().manual_seed(fold_in(self.cfg.seed, 0))
        init_parameters(self.model, gen)
        return TrainState(0, self.model,
                          make_optimizer(self.cfg, self.model.parameters()))

    def step_seed(self, step: int) -> int:
        """The seed of step `step`'s example synthesis."""
        return fold_in(self.cfg.seed, 1, step)

    def _loss(self, params, inputs, targets):
        out = self.model(inputs, train=True)
        loss = self.loss_fn(out, targets)
        if self.cfg.weight_decay:
            l2 = sum(torch.sum(p ** 2) for p in params)
            loss = loss + self.cfg.weight_decay * 0.5 * l2
        with torch.no_grad():
            mse = torch.mean((out - targets) ** 2)
        return loss, mse

    def _update(self, state: TrainState, inputs, targets) -> dict:
        """Forward, backward, clipping and the optimizer update on a
        device batch; no host synchronisation, so a graph can capture
        it. Returns the metrics as 0-dim device tensors."""
        cfg = self.cfg
        params = [p for p in state.model.parameters() if p.requires_grad]
        state.optimizer.zero_grad(set_to_none=True)
        accum = max(1, cfg.grad_accum)
        if inputs.shape[0] % accum:
            raise ValueError(f"batch {inputs.shape[0]} does not split into "
                             f"grad_accum={accum} microbatches")
        # BatchNorm statistics chain from one microbatch to the next;
        # gradients add up in .grad and are averaged after.
        losses, mses = [], []
        for x, t in zip(inputs.chunk(accum), targets.chunk(accum)):
            loss, mse = self._loss(params, x, t)
            loss.backward()
            losses.append(loss.detach())
            mses.append(mse)
        grads = [p.grad for p in params if p.grad is not None]
        with torch.no_grad():
            if accum > 1:
                for g in grads:
                    g.div_(accum)
            grad_norm = torch.sqrt(sum(torch.sum(g ** 2) for g in grads))
            if cfg.grad_clip_norm > 0:
                keep = grad_norm < cfg.grad_clip_norm
                for g in grads:
                    g.copy_(torch.where(
                        keep, g, g / grad_norm * cfg.grad_clip_norm))
        state.optimizer.step()
        return {"loss": sum(losses) / accum, "mse": sum(mses) / accum,
                "grad_norm": grad_norm}

    def _to_device(self, t) -> torch.Tensor:
        """A host tensor or array to the device, through pinned memory."""
        t = torch.as_tensor(t)
        if t.device.type == "cpu" and self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def step_fn(self, state: TrainState, batch):
        """One optimizer step; returns (state, metrics) with the metrics
        `loss`, `mse` and `grad_norm` as 0-dim tensors on the device."""
        if self.example_fn is not None:
            # Integer corpora upload raw and convert here, on the device.
            batch = self._to_device(batch).float()
            seed = self.step_seed(state.step)
            inputs, targets = self.example_fn(seed, batch)
        else:
            inputs, targets = (self._to_device(t) for t in batch)
        metrics = self._update(state, inputs, targets)
        state.step += 1
        return state, metrics

    def _launch(self, state: TrainState, batches) -> torch.Tensor:
        """K steps as one replay of the step graph (captured at the first
        launch, and again when a tensor it reads was replaced); returns
        the (K, 3) metrics of the K steps."""
        seeds = [self.step_seed(state.step + i) for i in range(len(batches))]
        if self.graph is None or self.graph.key != StepGraph.state_key(state):
            self.graph = None
            self.graph = StepGraph(self, state, batches, seeds)
            self.graph_stats["captures"] += 1
            self.graph_stats["capture_s"] += self.graph.capture_s
        else:
            b = batches[0].shape[0]
            self.graph.stage(batches, [self.example_fn.draws(s, b,
                                                             self.device)
                                       for s in seeds])
        self.graph.replay()
        self.graph_stats["replays"] += 1
        self.graph_stats["k2_replayed"] += self.graph.k2_per_replay
        state.step += len(batches)
        return self.graph.metrics

    def fit(self, state: TrainState, pipeline, num_steps: int,
            checkpointer=None, eval_fn: Callable | None = None,
            eval_every: int = 0) -> TrainState:
        """Step until `num_steps` (with K = steps_per_launch > 1, in
        launches of K steps, overshooting to a multiple of K as emx
        does), logging every `log_every` steps, polling
        `learning_rate.txt`, evaluating every `eval_every`, dumping
        samples every `sample_every`, tracing `profile_num_steps` steps
        from `profile_start_step` into `profile_dir` (once a run: emx's
        loop starts a new trace after each), and saving
        checkpoints by steps and by seconds with the pipeline cursor."""
        cfg = self.cfg
        batch_size = getattr(getattr(pipeline, "cfg", None), "batch_size", 1)
        meter = ThroughputMeter(batch_size, every=max(1, cfg.log_every))
        last_save = time.monotonic()
        it = iter(pipeline)
        spl = max(1, cfg.steps_per_launch)
        tracer, traced = None, False
        while state.step < num_steps:
            if (cfg.profile_dir and not traced
                    and state.step >= cfg.profile_start_step):
                tracer, traced = self._start_trace(), True
                trace_from = state.step
            if spl > 1:
                batches = [next(it) for _ in range(spl)]
                metrics = dict(zip(METRICS, self._launch(state, batches)[-1]))
                batch = batches[-1]  # the last step's, for sample dumps
            else:
                batch = next(it)
                state, metrics = self.step_fn(state, batch)
            step = state.step
            self.last_metrics = metrics

            if tracer is not None and (
                    step >= trace_from + cfg.profile_num_steps):
                self._stop_trace(tracer, trace_from)
                tracer = None

            if cfg.log_every and step % cfg.log_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                tp = meter.update(step)
                if tp:
                    vals.update(tp)
                self.logger.log(step, **vals)

            overrides = self._lr_poll()
            if overrides and "learning_rate" in overrides:
                set_learning_rate(state.optimizer,
                                  overrides["learning_rate"])

            if eval_fn and eval_every and step % eval_every == 0:
                eval_fn(state, step)

            if (cfg.sample_every and cfg.model_dir
                    and step % cfg.sample_every == 0):
                self._dump_samples(state, batch, step)

            if checkpointer is not None:
                due_steps = (cfg.ckpt_every_steps
                             and step % cfg.ckpt_every_steps == 0)
                due_time = (cfg.ckpt_every_secs and time.monotonic()
                            - last_save > cfg.ckpt_every_secs)
                if due_steps or due_time:
                    checkpointer.save(step, state, pipeline.state_dict())
                    last_save = time.monotonic()
        if tracer is not None:
            self._stop_trace(tracer, trace_from)
        return state

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        tracer = profile(activities=acts)
        tracer.__enter__()
        return tracer

    def _stop_trace(self, tracer, start: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tracer.__exit__(None, None, None)
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        tracer.export_chrome_trace(os.path.join(
            self.cfg.profile_dir, f"trace_step{start}.json"))

    def _dump_samples(self, state: TrainState, batch, step: int) -> None:
        """Periodic input/truth/output TIFF triples (reference
        gan-infilling-100.py:1694-1703 saves the same set), from the first
        image of the step's batch; a failure is logged, never raised."""
        from emx_torch.io.tiff import write_tiff
        from emx_torch.utils.image import scale0to1

        try:
            with torch.no_grad():
                if self.example_fn is not None:
                    first = self._to_device(batch)[:1].float()
                    inputs, targets = self.example_fn(
                        fold_in(self.cfg.seed, 0x5A5A5A), first)
                else:
                    inputs, targets = (torch.as_tensor(t)[:1].to(self.device)
                                       for t in batch)
                out = state.model(inputs, train=False)
            d = os.path.join(self.cfg.model_dir, "samples")
            for name, img in (("input", inputs), ("truth", targets),
                              ("output", out)):
                arr = scale0to1(img[0].float()).cpu().numpy()
                write_tiff(os.path.join(d, f"{step}_{name}.tif"),
                           arr.astype(np.float32))
        except Exception as e:  # sample dumps must never kill training
            self.logger.log(step, sample_dump_error=str(e)[:120])


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
    adds it;
  * `grad_clip_norm`: optax's `clip_by_global_norm`, g * max / |g| only
    where |g| >= max (not torch's clip_grad_norm_, which adds 1e-6);
  * `weight_decay`: 0.5 * wd * sum(p^2) over every parameter is added to
    the loss, as emx does, so `grad_norm` matches.

The learning rate lives in the optimizer's param groups, so the
`learning_rate.txt` hot reload sets it there. The step's randomness is
seeded from (TrainConfig.seed, step): a resumed run draws what an
uninterrupted one draws.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import torch
from torch import nn

from emx_torch.nn.init import init_parameters
from emx_torch.train.losses import huberised_mse
from emx_torch.utils.config import Config, config_field, watch_file
from emx_torch.utils.metrics import MetricsLogger, ThroughputMeter
from emx_torch.utils.rng import fold_in


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
    steps_per_launch: int = config_field(1, "optimizer steps fused into one device launch")
    log_every: int = config_field(100, "steps between metric lines")
    sample_every: int = config_field(0, "dump input/truth/output TIFFs every N steps (0 off)")
    ckpt_every_steps: int = config_field(0, "0 disables step-periodic saves")
    ckpt_every_secs: float = config_field(0.0, "0 disables time-periodic saves")
    model_dir: str = config_field("", "checkpoint/log directory")
    seed: int = config_field(0, "training RNG seed")
    profile_dir: str = config_field(
        "", "write a profiler trace here; empty disables")
    profile_start_step: int = config_field(10, "first traced step")
    profile_num_steps: int = config_field(5, "steps inside the trace")


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    params = list(params)
    if cfg.optimizer == "nesterov":
        return torch.optim.SGD(params, lr=cfg.learning_rate,
                               momentum=cfg.momentum, dampening=0.0,
                               nesterov=True)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate,
                                betas=(cfg.adam_b1, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group, in place."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def _unported(cfg: TrainConfig, probe) -> str | None:
    if cfg.steps_per_launch > 1:
        return "steps_per_launch > 1"
    if probe is not None:
        return "the dose probe"
    if cfg.profile_dir:
        return "profile_dir"
    if cfg.sample_every:
        return "sample_every"
    return None


class Trainer:
    """Supervised trainer for (input, target)-style models.

    Args:
      model: a module on its device whose forward(x, train=...) returns
        predictions.
      example_fn: (seed, clean batch) -> (inputs, targets), run on the
        batch's device (see emx_torch.data.degrade). If None, batches
        must already be (inputs, targets) pairs.
      loss_fn: (pred, target) -> scalar; the reference's huberised MSE
        by default.
    """

    def __init__(self, model: nn.Module, cfg: TrainConfig,
                 example_fn: Callable | None = None,
                 loss_fn: Callable = huberised_mse, probe=None):
        what = _unported(cfg, probe)
        if what:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md Queue 1)")
        self.model = model
        self.cfg = cfg
        self.example_fn = example_fn
        self.loss_fn = loss_fn
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

    def _loss(self, params, inputs, targets):
        out = self.model(inputs, train=True)
        loss = self.loss_fn(out, targets)
        if self.cfg.weight_decay:
            l2 = sum(torch.sum(p ** 2) for p in params)
            loss = loss + self.cfg.weight_decay * 0.5 * l2
        with torch.no_grad():
            mse = torch.mean((out - targets) ** 2)
        return loss, mse

    def step_fn(self, state: TrainState, batch):
        """One optimizer step; returns (state, metrics) with the metrics
        `loss`, `mse` and `grad_norm` as 0-dim tensors on the device."""
        cfg = self.cfg
        params = [p for p in state.model.parameters() if p.requires_grad]
        if self.example_fn is not None:
            # Integer corpora upload raw and convert here, on the device.
            batch = torch.as_tensor(batch).to(self.device).float()
            inputs, targets = self.example_fn(
                fold_in(cfg.seed, 1, state.step), batch)
        else:
            inputs, targets = (torch.as_tensor(t).to(self.device)
                               for t in batch)

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
        state.step += 1
        return state, {"loss": sum(losses) / accum, "mse": sum(mses) / accum,
                       "grad_norm": grad_norm}

    def fit(self, state: TrainState, pipeline, num_steps: int,
            checkpointer=None, eval_fn: Callable | None = None,
            eval_every: int = 0) -> TrainState:
        """Step until `num_steps`, logging every `log_every` steps, polling
        `learning_rate.txt`, evaluating every `eval_every` and saving
        checkpoints by steps and by seconds with the pipeline cursor."""
        cfg = self.cfg
        batch_size = getattr(getattr(pipeline, "cfg", None), "batch_size", 1)
        meter = ThroughputMeter(batch_size, every=max(1, cfg.log_every))
        last_save = time.monotonic()
        it = iter(pipeline)
        while state.step < num_steps:
            state, metrics = self.step_fn(state, next(it))
            step = state.step

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

            if checkpointer is not None:
                due_steps = (cfg.ckpt_every_steps
                             and step % cfg.ckpt_every_steps == 0)
                due_time = (cfg.ckpt_every_secs and time.monotonic()
                            - last_save > cfg.ckpt_every_secs)
                if due_steps or due_time:
                    checkpointer.save(step, state, pipeline.state_dict())
                    last_save = time.monotonic()
        return state

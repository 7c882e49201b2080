"""GAN training engine (port of emx/train/gan.py): one G+D step with the
reference's adaptive training dynamics, driven from a host loop.

Reproduces (misc_py/gan-infilling-100.py):
  * generator loss: -log D(fake) + 12 * feature-matching L1 across all
    discriminator activations (:1025-1036), + mse_weight * MSE;
  * discriminator loss: -log(1 - |label - prob|), adapt-rate scaled,
    + 0.5 * 5e-5 * sum(p^2) over every discriminator parameter (biases
    and norm scales included; a term of the loss, not weight decay)
    (:1081-1089);
  * label flipping with prob 0.01*(1-p_avg)^7, flipped/real labels
    0.9 + 0.1*u, adapt rate 10*exp(-p)*(1-exp(-p^2)) (:1726-1734);
  * adaptive trainee switching on the window-averaged D(fake) with
    0.3/0.7 bands every trainee_switch_skip_n steps, a forced flip after
    max_num_since_change one-sided windows (:1903-1940), and collapse
    rollback on D(x) == 0.5 (:1827-1831);
  * Adam beta1 0.5 after optax's clip_by_global_norm, 50 (G) / 15 (D)
    (:1378-1441): g * max / |g| only where |g| >= max, not torch's
    clip_grad_norm_, which adds 1e-6.

Every step computes both losses and both gradients, as emx's does (the
metrics and the EMAs read them); only the trainee's optimizer steps, so
the other net's parameters and its whole optimizer state, Adam's count
included, stay as they were (emx's gated update). `fit` never applies
`lr_at`, as emx's does not.

A step's randomness comes from `step_draws` (seeded by (GANConfig.seed,
step)): the example draws (one D4 choice per image), the offsets of the
fake/real crops `crops_f` (used for both crops of the generator loss and
for the fake crops of the discriminator loss, as emx shares k_cf) and
`crops_r` (the real crops of the discriminator loss), and three
uniforms (two label flips, one label smoothing). `step_fn` takes them
from the caller when given, so a test can feed it emx's draws.

Data parallelism (`mesh=`) follows emx_torch.train.engine's rules: each
rank keeps its rows of the global batch and draws them as the global
batch draws them; D's mean outputs on fake and real crops are averaged
over the batch axes (differentiably) before the log terms read them, so
every loss is the global batch's; the trainee's gradients are averaged
before clipping, and the metrics are global means. So every host
decision in `fit` (rollback, trainee switch) reads numbers that are equal
on every rank, and the ranks switch at the same steps. Only rank 0
writes checkpoints and the metrics log; every rank restores.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from emx_torch.nn.infilling import crop_offsets, multiscale_crops
from emx_torch.nn.init import init_parameters
from emx_torch.parallel.mesh import (all_reduce_mean, all_reduce_mean_,
                                     microbatch_rows, rank, replicated)
from emx_torch.train.engine import join_mesh
from emx_torch.utils.config import Config, config_field
from emx_torch.utils.metrics import MetricsLogger, ThroughputMeter
from emx_torch.utils.rng import fold_in

METRICS = ("gen_loss", "disc_loss", "d_fake", "d_fake_after", "d_real", "mse")


@dataclasses.dataclass
class GANState:
    """What a step changes: the step count, both nets and both optimizers
    (in place), and the prediction EMAs (0-dim tensors on the device)."""

    step: int
    gen: nn.Module
    disc: nn.Module
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer
    pred_avg: torch.Tensor        # EMA of D(fake) (p_avg in the reference)
    pred_avg_real: torch.Tensor   # EMA of 1 - D(real)

    def state_dict(self) -> dict:
        return {"step": int(self.step), "gen": self.gen.state_dict(),
                "disc": self.disc.state_dict(),
                "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(),
                "pred_avg": self.pred_avg.detach().clone(),
                "pred_avg_real": self.pred_avg_real.detach().clone()}

    def load_state_dict(self, d: dict) -> None:
        """Load in place (the tensors keep their devices)."""
        self.gen.load_state_dict(d["gen"])
        self.disc.load_state_dict(d["disc"])
        self.gen_opt.load_state_dict(d["gen_opt"])
        self.disc_opt.load_state_dict(d["disc_opt"])
        with torch.no_grad():
            self.pred_avg.copy_(d["pred_avg"])
            self.pred_avg_real.copy_(d["pred_avg_real"])
        self.step = int(d["step"])


@dataclasses.dataclass
class GANConfig(Config):
    gen_lr: float = config_field(2e-4, "generator Adam lr")
    disc_lr: float = config_field(2e-4, "discriminator Adam lr")
    adam_b1: float = config_field(0.5, "Adam beta1 for both nets")
    gen_clip: float = config_field(50.0, "generator grad-norm clip")
    disc_clip: float = config_field(15.0, "discriminator grad-norm clip")
    feature_match_weight: float = config_field(12.0, "natural-statistics L1 weight")
    mse_weight: float = config_field(
        0.0, "direct reconstruction weight in the generator loss "
             "(0 = reference-faithful adv + feature matching only)")
    disc_l2: float = config_field(5e-5, "discriminator L2 penalty")
    ema_decay: float = config_field(0.99, "prediction EMA decay")
    switch_low: float = config_field(0.3, "train G below this D(fake) EMA")
    switch_high: float = config_field(0.7, "train D above this D(fake) EMA")
    trainee_switch_skip_n: int = config_field(
        1, "decide the trainee every N steps on the window-averaged D(fake) "
           "(reference gan-infilling-100.py:1903-1906)")
    max_num_since_change: int = config_field(
        0, "force a trainee flip after this many consecutive one-sided "
           "decision windows so neither net starves (reference "
           "max_num_since_training_change :1922-1925; 0 disables)")
    collapse_eps: float = config_field(1e-6, "|D-0.5| collapse detector")
    log_every: int = config_field(100, "metric cadence")
    ckpt_every_steps: int = config_field(0, "0 disables")
    model_dir: str = config_field("", "log/checkpoint dir")
    seed: int = config_field(0, "RNG seed")
    lr_decay_start: int = config_field(350_000, "staircase decay start step")
    lr_decay_every: int = config_field(50_000, "decay interval")
    lr_decay_frac: float = config_field(0.125, "fraction removed per interval")
    max_steps: int = config_field(700_000, "reference hard stop")


def _flip_prob(p_avg):
    return 0.01 * (1.0 - p_avg) ** 7


def _adapt_rate(p_avg):
    return 10.0 * torch.exp(-p_avg) * (1.0 - torch.exp(-p_avg * p_avg))


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g * max / |g| where |g| >= max.
    Returns |g| (before clipping)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class GANTrainer:
    """Args:
      generator, discriminator: modules on one device
        (emx_torch.nn.infilling).
      cfg: GANConfig.
      mesh: an emx_torch.parallel.mesh.Mesh to train data-parallel over
        its batch axes (module docstring); None: the nets' device alone.
      example_fn: a SplitExample (seed, clean batch) -> (partial scans,
        full images), e.g. emx_torch.data.degrade.infilling_example(mask);
        if None, batches must already be (inputs, truths) pairs.
    """

    def __init__(self, generator: nn.Module, discriminator: nn.Module,
                 cfg: GANConfig, mesh=None,
                 example_fn: Callable | None = None):
        self.gen = generator
        self.disc = discriminator
        self.cfg = cfg
        self.mesh = mesh
        self.block, self.blocks, self.group, _, self.example_fn = join_mesh(
            mesh, (generator, discriminator), example_fn)
        self.writer = rank() == 0
        self.logger = MetricsLogger(cfg.model_dir if self.writer else None)
        # What fit's host loop did (emx only logs these).
        self.stats = {"rollbacks": 0, "forced_switches": 0}

    @property
    def device(self) -> torch.device:
        return next(self.gen.parameters()).device

    # ------------------------------------------------------------------
    def init(self, sample_batch=None) -> GANState:
        """Both nets initialised from GANConfig.seed (flax's default
        distributions, emx_torch.nn.init) and fresh Adam optimizers.
        `sample_batch` is accepted for emx's signature: a torch module
        knows its shapes without one."""
        for i, net in enumerate((self.gen, self.disc)):
            init_parameters(net, torch.Generator().manual_seed(
                fold_in(self.cfg.seed, 0, i)))
        state = self.new_state()
        self.replicate(state)
        return state

    def replicate(self, state: GANState) -> None:
        """Make the state equal on every rank of the mesh: the first
        rank's nets, optimizer states and EMAs, in place."""
        if self.mesh is None:
            return
        tensors = [state.pred_avg, state.pred_avg_real]
        for net, opt in ((state.gen, state.gen_opt),
                         (state.disc, state.disc_opt)):
            tensors += list(net.parameters()) + list(net.buffers())
            for st in opt.state.values():
                tensors += [v for v in st.values() if torch.is_tensor(v)]
        replicated(self.mesh).broadcast_(tensors)


    def new_state(self) -> GANState:
        """A step-0 state around both nets as they stand (no
        re-initialisation): fresh Adam optimizers, EMAs at 0.5."""
        cfg = self.cfg
        dtype = next(self.gen.parameters()).dtype
        half = torch.tensor(0.5, dtype=dtype, device=self.device)
        return GANState(
            0, self.gen, self.disc,
            torch.optim.Adam(self.gen.parameters(), lr=cfg.gen_lr,
                             betas=(cfg.adam_b1, 0.999), eps=1e-8),
            torch.optim.Adam(self.disc.parameters(), lr=cfg.disc_lr,
                             betas=(cfg.adam_b1, 0.999), eps=1e-8),
            half, half.clone())

    def step_draws(self, step: int, b: int, h: int) -> dict:
        """Step `step`'s random values for a batch of b h x h images."""
        seed = fold_in(self.cfg.seed, 1, step)
        gen = torch.Generator().manual_seed(fold_in(seed, 1))
        draws = {"crops_f": crop_offsets(gen, h),
                 "crops_r": crop_offsets(gen, h)}
        u = torch.rand(3, generator=gen, dtype=torch.float64).tolist()
        draws.update(flip_f=u[0], flip_r=u[1], label=u[2])
        if self.example_fn is not None:
            draws["example"] = self.example_fn.draws(fold_in(seed, 0), b,
                                                     self.device)
        return draws

    # ------------------------------------------------------------------
    def step_fn(self, state: GANState, batch, do_gen: bool, do_disc: bool,
                draws: dict | None = None):
        """One G+D step on a global batch (of which a data-parallel rank
        keeps its rows); returns (state, metrics) with the metrics of
        METRICS as 0-dim device tensors, global means. `do_gen` /
        `do_disc` say which optimizer steps."""
        cfg = self.cfg
        batch = microbatch_rows(batch, self.block, self.blocks)
        if self.example_fn is not None:
            batch = torch.as_tensor(batch).to(self.device).float()
            if draws is None:
                draws = self.step_draws(state.step, batch.shape[0],
                                        batch.shape[-1])
            lq, truth = self.example_fn.apply(draws["example"], batch)
        else:
            lq, truth = (torch.as_tensor(t).to(self.device) for t in batch)
            if draws is None:
                draws = self.step_draws(state.step, lq.shape[0],
                                        lq.shape[-2])
        gen, disc = state.gen, state.disc
        # A parameter the graph does not reach (a norm over one value per
        # group returns its bias) gets a zero gradient, as under jax.grad.
        gen_params = list(gen.parameters())
        disc_params = list(disc.parameters())

        # ---------------- generator loss ----------------
        fake = gen(lq, train=True)
        p_fake, feats_f = disc(multiscale_crops(draws["crops_f"], fake),
                               train=False)
        with torch.no_grad():
            _, feats_r = disc(multiscale_crops(draws["crops_f"], truth),
                              train=False)
        fm = sum(torch.mean(torch.abs(a - b))
                 for a, b in zip(feats_f, feats_r))
        p_fake_mean = all_reduce_mean(torch.mean(p_fake), self.group)
        adv = -torch.log(torch.clamp(p_fake_mean, 1e-8, 1.0))
        mse = torch.mean((fake - truth) ** 2)
        g_loss = adv + cfg.feature_match_weight * fm + cfg.mse_weight * mse
        g_grads = torch.autograd.grad(g_loss, gen_params, allow_unused=True,
                                      materialize_grads=True)

        # ---------------- discriminator loss ----------------
        pred_avg, pred_avg_real = state.pred_avg, state.pred_avg_real
        flip_f = draws["flip_f"] < _flip_prob(pred_avg)
        flip_r = draws["flip_r"] < _flip_prob(pred_avg_real)
        smooth = 0.9 + 0.1 * draws["label"] - 1e-8
        tiny = torch.full_like(pred_avg, 1e-8)
        fake_label = torch.where(flip_f, torch.full_like(tiny, smooth), tiny)
        real_label = torch.where(flip_r, tiny, torch.full_like(tiny, smooth))
        adapt = torch.where(flip_f, torch.ones_like(tiny),
                            _adapt_rate(pred_avg))
        p_f, _ = disc(multiscale_crops(draws["crops_f"], fake.detach()),
                      train=True)
        p_r, _ = disc(multiscale_crops(draws["crops_r"], truth), train=True)
        p_f = all_reduce_mean(torch.mean(p_f), self.group)
        p_r = all_reduce_mean(torch.mean(p_r), self.group)
        lf = -torch.log(torch.clamp(1.0 - torch.abs(fake_label - p_f),
                                    1e-8, 1.0 - 1e-8))
        lr_ = -torch.log(torch.clamp(1.0 - torch.abs(real_label - p_r),
                                     1e-8, 1.0 - 1e-8))
        l2 = sum(torch.sum(p * p) for p in disc_params)
        d_loss = adapt * lf + lr_ + cfg.disc_l2 * 0.5 * l2
        d_grads = torch.autograd.grad(d_loss, disc_params, allow_unused=True,
                                      materialize_grads=True)

        # ---------------- gated updates ----------------
        for on, params, grads, opt, clip in (
                (do_gen, gen_params, g_grads, state.gen_opt, cfg.gen_clip),
                (do_disc, disc_params, d_grads, state.disc_opt,
                 cfg.disc_clip)):
            if not on:
                continue
            with torch.no_grad():
                grads = [g.clone() for g in grads]
                if self.group is not None:
                    all_reduce_mean_(grads, self.group, self.blocks)
                clip_by_global_norm_(grads, clip)
            for p, g in zip(params, grads):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)

        # Prediction EMAs (reference :1906-1915).
        with torch.no_grad():
            d = cfg.ema_decay
            state.pred_avg = d * pred_avg + (1 - d) * p_fake_mean.detach()
            state.pred_avg_real = d * pred_avg_real + (1 - d) * (
                1.0 - p_r.detach())
        state.step += 1
        metrics = {"gen_loss": g_loss, "disc_loss": d_loss,
                   "d_fake": p_fake_mean, "d_fake_after": p_f,
                   "d_real": p_r, "mse": mse}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.group is not None:
            # The losses and the MSE hold this rank's rows: their global
            # means (D's outputs are global already).
            local = ("gen_loss", "disc_loss", "mse")
            means = torch.stack([metrics[k] for k in local])
            all_reduce_mean_([means], self.group, self.blocks)
            metrics.update(zip(local, means.unbind()))
        return state, metrics

    # ------------------------------------------------------------------
    def lr_at(self, step: int) -> float:
        """Staircase decay: from lr to 0 in lr_decay_frac steps after
        lr_decay_start (reference :1635-1642). fit does not apply it."""
        cfg = self.cfg
        if step < cfg.lr_decay_start:
            return cfg.gen_lr
        n = 1 + (step - cfg.lr_decay_start) // cfg.lr_decay_every
        return max(0.0, cfg.gen_lr * (1.0 - cfg.lr_decay_frac * n))

    def fit(self, state: GANState, pipeline, num_steps: int,
            checkpointer=None, eval_fn=None, eval_every: int = 0
            ) -> GANState:
        """Host loop: adaptive trainee switching and collapse rollback.
        `eval_fn(state, step)` runs every `eval_every` steps (the
        reference's val pass every val_skip_n iterations,
        gan-infilling-100.py:123,1834-1901). As emx's, the loop runs
        num_steps - state.step iterations, counted when it starts: a
        rollback does not extend it."""
        cfg = self.cfg
        batch_size = getattr(getattr(pipeline, "cfg", None), "batch_size", 1)
        meter = ThroughputMeter(batch_size, every=max(1, cfg.log_every))
        train_gen = True
        num_since_change = 0
        window_pred = 0.0
        window_n = 0
        forced_switches = 0
        rollbacks = 0
        it = iter(pipeline)
        self.replicate(state)
        for _ in range(int(state.step), num_steps):
            state, metrics = self.step_fn(state, next(it), train_gen,
                                          not train_gen)
            step = int(state.step)
            d_fake = float(metrics["d_fake"])
            d_real = float(metrics["d_real"])

            # Collapse rollback (reference :1827-1831).
            if checkpointer is not None \
                    and abs(d_real - 0.5) < cfg.collapse_eps \
                    and abs(d_fake - 0.5) < cfg.collapse_eps and step > 10:
                try:
                    state, _ = checkpointer.rollback(state)
                    rollbacks += 1
                    self.stats["rollbacks"] += 1
                    self.logger.log(step, rollback=float(rollbacks))
                    continue
                except FileNotFoundError:
                    pass

            # Trainee switching every trainee_switch_skip_n steps on the
            # window-averaged D(fake) (reference :1903-1940), with a
            # forced flip after max_num_since_change consecutive
            # one-sided windows (reference :1922-1925).
            window_pred += d_fake
            window_n += 1
            if window_n >= max(1, cfg.trainee_switch_skip_n):
                avg_pred = window_pred / window_n
                window_pred, window_n = 0.0, 0
                if cfg.max_num_since_change and \
                        num_since_change >= cfg.max_num_since_change:
                    num_since_change = 1
                    train_gen = not train_gen
                    forced_switches += 1
                    self.stats["forced_switches"] += 1
                elif avg_pred < cfg.switch_low:
                    num_since_change = num_since_change + 1 if train_gen else 0
                    train_gen = True
                elif avg_pred > cfg.switch_high:
                    num_since_change = 0 if train_gen else num_since_change + 1
                    train_gen = False
                else:
                    num_since_change = 0
                    train_gen = not train_gen

            if cfg.log_every and step % cfg.log_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                vals["train_gen"] = float(train_gen)
                vals["num_since_change"] = float(num_since_change)
                if forced_switches:
                    vals["forced_switches"] = float(forced_switches)
                tp = meter.update(step)
                if tp:
                    vals.update(tp)
                self.logger.log(step, **vals)

            if eval_fn and eval_every and step % eval_every == 0:
                eval_fn(state, step)

            if checkpointer is not None and cfg.ckpt_every_steps and \
                    step % cfg.ckpt_every_steps == 0:
                if self.writer:
                    checkpointer.save(step, state, pipeline.state_dict())
                if self.blocks > 1 and self.group is not None:
                    # A rollback on any rank restores this file.
                    torch.distributed.barrier(group=self.group)
        return state

"""Per-dose-bin adaptive loss probing (port of emx/train/dose_probe.py).

Rebuilds the reference's dynamic training-dose adjustment
(misc_py/encoder-decoder.py get_training_probs:939-959 and the eval loop
:1042-1052): the validation loss is measured separately at each of
`num_bins` Poisson dose means; the per-bin loss improvements since the
previous probe (boxcar-smoothed, clamped at 0, floored at 5% of the max)
become a cumulative sampling distribution, and training examples draw
their dose by inverse-CDF from it.

The probe state (previous losses, CDF) lives on the host; a training
example's dose is drawn there too, with its D4 choice and the degrade
kernel's key (the draws of a SplitExample), from the CDF as it stands
at that step. The per-bin evaluation degrades the whole
validation set at every bin in one launch of the fused Poisson kernel
(K2) and runs the model on it bin by bin.
"""

from __future__ import annotations

import numpy as np
import torch

from emx_torch.data.degrade import SplitExample, denoiser_apply, poisson_dose
from emx_torch.ops.degrade_kernel import seed_tensor
from emx_torch.utils.image import sanitize, scale0to1
from emx_torch.utils.rng import fold_in


def moving_average(values: np.ndarray, window: int) -> np.ndarray:
    """Boxcar smoothing, 'same' length (reference movingAverage:930-935)."""
    if window <= 1:
        return np.asarray(values, np.float32)
    w = np.repeat(1.0, window) / window
    return np.convolve(values, w, "same").astype(np.float32)


def training_probs(prev_losses, new_losses, smoothing: int = 5,
                   floor: float = 0.05) -> np.ndarray:
    """Cumulative per-bin sampling probabilities from two loss probes
    (reference get_training_probs:938-956): positive smoothed
    improvements + a `floor`*max offset, normalised cumsum."""
    diffs = moving_average(prev_losses, smoothing) - moving_average(
        new_losses, smoothing)
    diffs = np.maximum(diffs, 0.0)
    max_diff = float(np.max(diffs))
    if max_diff == 0.0:
        max_diff = 1.0
    diffs = diffs + floor * max_diff
    cum = np.cumsum(diffs)
    return (cum / cum[-1]).astype(np.float32)


def sample_dose(u: torch.Tensor, cum_probs: torch.Tensor,
                dose_means: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw of a dose mean for each uniform in `u` (emx's
    sample_dose draws its uniform from a key; the port takes it)."""
    idx = torch.searchsorted(cum_probs, u, right=False)
    return dose_means[torch.clamp(idx, 0, dose_means.shape[0] - 1)]


def probed_draws(seed: int, b: int, cum_probs, dose_means,
                 device: torch.device | str = "cpu"
                 ) -> dict[str, torch.Tensor]:
    """denoiser_draws with each image's dose drawn from `cum_probs` over
    `dose_means` (numpy or CPU tensors) instead of 25 + Exp(75), on the
    host, then moved to `device`."""
    gen = torch.Generator().manual_seed(fold_in(seed, 0))
    d4 = torch.randint(0, 8, (b,), generator=gen)
    u = torch.rand(b, generator=gen)
    scales = sample_dose(u, torch.as_tensor(cum_probs),
                         torch.as_tensor(dose_means))
    return {"d4": d4.to(device), "scales": scales.float().to(device),
            "key": seed_tensor(fold_in(seed, 1), device)}


def probed_denoiser_example(seed: int, imgs: torch.Tensor, cum_probs,
                            dose_means):
    """A batch of (noisy, target) pairs as denoiser_example makes them,
    with the doses drawn from the probe's CDF; the degrade is one K2
    launch for the batch."""
    return SplitExample(
        lambda s, b, dev: probed_draws(s, b, cum_probs, dose_means, dev),
        denoiser_apply)(seed, imgs)


class DoseProbe:
    """Host-side probe state and the batched per-bin evaluation.

    Usage with the Trainer (see emx_torch.train.engine):
        probe = DoseProbe(num_bins=20)
        trainer = Trainer(model, cfg, example_fn=probe.example_fn,
                          probe=probe)
        trainer.fit(state, pipe, steps,
                    eval_fn=probe.make_eval_hook(trainer, val_images),
                    eval_every=500)
    """

    def __init__(self, num_bins: int = 20, dose_min: float = 25.0,
                 dose_max: float = 400.0, smoothing: int = 5,
                 floor: float = 0.05):
        self.dose_means = np.linspace(dose_min, dose_max, num_bins).astype(
            np.float32)
        self.smoothing = smoothing
        self.floor = floor
        self.prev_losses: np.ndarray | None = None
        # Uniform CDF until two probes exist.
        self.cum_probs = (np.arange(1, num_bins + 1) / num_bins).astype(
            np.float32)

    # -- the example --------------------------------------------------------
    def draws(self, seed: int, b: int, device: torch.device | str = "cpu"
              ) -> dict[str, torch.Tensor]:
        return probed_draws(seed, b, self.cum_probs, self.dose_means,
                            device)

    @property
    def example_fn(self) -> SplitExample:
        """denoiser_example with the dose drawn from the probe's CDF as it
        stands at each step."""
        return SplitExample(self.draws, denoiser_apply)

    # -- host-side --------------------------------------------------------
    def update(self, losses) -> np.ndarray:
        """Feed a new per-bin loss probe; returns the refreshed CDF."""
        losses = np.asarray(losses, np.float32)
        if self.prev_losses is not None:
            self.cum_probs = training_probs(
                self.prev_losses, losses, self.smoothing, self.floor)
        self.prev_losses = losses
        return self.cum_probs

    def probe_losses(self, model, val: torch.Tensor, seed: int,
                     loss_fn=None) -> np.ndarray:
        """The validation loss at each dose bin: every image degraded at
        every bin's fixed dose in one K2 launch, then one forward per bin
        in inference mode."""
        from emx_torch.train.losses import huberised_mse

        loss_fn = loss_fn or huberised_mse
        nb, n = len(self.dose_means), val.shape[0]
        imgs = scale0to1(sanitize(val.float()), dim=(-2, -1))
        tiled = imgs.repeat(nb, 1, 1).contiguous()
        scales = torch.from_numpy(np.repeat(self.dose_means, n)).to(
            val.device)
        lq = poisson_dose(seed, tiled, scales)
        tgt = tiled * (lq.mean(dim=(-2, -1), keepdim=True) / torch.clamp(
            tiled.mean(dim=(-2, -1), keepdim=True), min=1e-12))
        losses = []
        with torch.no_grad():
            for i in range(nb):
                sl = slice(i * n, (i + 1) * n)
                out = model(lq[sl], train=False)
                losses.append(loss_fn(out.float(), tgt[sl]))
        return torch.stack(losses).cpu().numpy()

    def make_eval_hook(self, trainer, val_images, loss_fn=None):
        """eval_fn(state, step) for Trainer.fit: measures the val loss at
        every dose bin (probe_losses, seeded by the step) and updates the
        CDF."""
        val = torch.as_tensor(np.asarray(val_images, np.float32)).to(
            trainer.device)

        def hook(state, step):
            losses = self.probe_losses(state.model, val,
                                       fold_in(trainer.cfg.seed, 2, step),
                                       loss_fn)
            self.update(losses)
            if getattr(trainer, "logger", None) is not None:
                trainer.logger.log(step,
                                   dose_probe_max=float(np.max(losses)),
                                   dose_probe_min=float(np.min(losses)))

        return hook

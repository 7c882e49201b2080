"""Batched twin of FresnelEnv for large-scale DQN training (port of
emx/scope/vec_env.py).

The reference trains its keras-rl autofocus agent for 1.75M serial
hardware steps (em_env/fresnel_remover.py:93-118). This module restates
the serial stack's episode semantics as a function of a state of tensors
on the card: B episodes advance per call, one batched FFT propagation
(cuFFT) and one Poisson draw per acquired frame.

Contracts kept identical to the serial stack, so a trained policy
evaluates on the serial FresnelEnv unchanged:
  * physics: pure phase object -> defocus CTF propagation -> Poisson
    dose -> per-frame min-max normalisation (emx_torch/scope/sim.py
    acquire);
  * observation: (prev, cur, action/max_shift) planes
    (emx_torch.scope.env.StackedFresnelEnv);
  * raw reward: +-1 on improvement (em_env/fresnel_env.py:114-124),
    with the potential-based shaping of emx_torch.bench.dqn_run.

Episodes place the optimum at z=0 exactly (the physics depends only on
z - z_opt, and the network never observes z), where FresnelEnv estimates
it with a focal scan. Evaluation goes through the scan-estimating serial
env.

Random draws come from one `torch.Generator` on the env's device, kept
in the state: the auto-reset draws of a step (start offset, specimen;
`step_draws`) and the Poisson counts. emx draws from `jax.random`, which
the port cannot reproduce; so `step` takes its auto-reset draws as an
argument, and a test hands both packages the same ones (with `dose=0`,
no noise). The counts are `torch.poisson`, as emx's are exact
`jax.random.poisson`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from emx_torch.physics.ctf import defocus_ctf
from emx_torch.scope.sim import disc_specimen
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VecFresnelConfig:
    batch: int = 128
    image_size: int = 48
    num_specimens: int = 512
    max_shift: float = 1.0
    max_z_dist: float = 3.0
    proximity: float = 0.15
    max_episode_steps: int = 16
    defocus_per_z: float = 200.0
    wavelength: float = 0.025
    phase_strength: float = 1.0
    dose: float = 2000.0
    specimen_seed: int = 0
    # Build the pool from windows panned over large globally-normalised
    # specimen maps, the serial SimulatedMicroscope's observation
    # distribution (sim.py _window pans a 4x map). Per-crop normalised
    # independent specimens leave the policy saturating on ~25% of
    # serial eval episodes (emx's finding).
    windowed_pool: bool = True


def specimen_pool(cfg: VecFresnelConfig) -> np.ndarray:
    """The (num_specimens, size, size) float32 phase maps, drawn from
    numpy as emx's VecFresnelEnv draws them."""
    if not cfg.windowed_pool:
        return disc_specimen(cfg.num_specimens, cfg.image_size,
                             seed=cfg.specimen_seed)
    rng = np.random.default_rng(cfg.specimen_seed)
    big_n = max(1, cfg.num_specimens // 32)
    big_side = 4 * cfg.image_size
    big = disc_specimen(big_n, big_side, seed=cfg.specimen_seed)
    hi = big_side - cfg.image_size
    pool = np.empty((cfg.num_specimens, cfg.image_size, cfg.image_size),
                    np.float32)
    for i in range(cfg.num_specimens):
        b = big[rng.integers(0, big_n)]
        cy, cx = rng.integers(0, hi, 2)
        pool[i] = b[cy:cy + cfg.image_size, cx:cx + cfg.image_size]
    return pool


class VecFresnelEnv:
    """B independent autofocus episodes stepped by one call.

    step() auto-resets finished episodes; the returned transition carries
    done=True so a Q-learning target masks the bootstrap, making the
    post-reset observation safe to store as next_obs.
    """

    def __init__(self, cfg: VecFresnelConfig = VecFresnelConfig(),
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._pool = torch.from_numpy(specimen_pool(cfg)).to(self.device)

    # -- batched physics (emx_torch/scope/sim.py acquire) --------------------
    def acquire(self, spec: torch.Tensor, z: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Normalised frames of phase maps `spec` (B, H, W) at offsets `z`
        (B,) from focus; Poisson counts from `generator` unless the dose
        is 0 (a noiseless camera)."""
        cfg = self.cfg
        wave = torch.exp(1j * cfg.phase_strength * spec).to(torch.complex64)
        defocus = (z * cfg.defocus_per_z)[:, None, None]
        ctf = defocus_ctf(cfg.image_size, cfg.wavelength, defocus)
        intensity = torch.fft.ifft2(torch.fft.fft2(wave) * ctf).abs() ** 2
        if cfg.dose <= 0:
            counts = intensity
        else:
            mean = intensity.mean((-2, -1), keepdim=True)
            lam = intensity * (cfg.dose / torch.clamp(mean, min=1e-9))
            counts = torch.poisson(lam, generator=generator)
        lo = counts.amin((-2, -1), keepdim=True)
        hi = counts.amax((-2, -1), keepdim=True)
        return torch.where(hi > lo,
                           (counts - lo) / torch.clamp(hi - lo, min=1e-9),
                           torch.full_like(counts, 0.5))

    def sample_start(self, generator: torch.Generator, n: int):
        """Start offsets as FresnelEnv.reset draws them: |z| ~ U(0.3, 1.0)
        * max_z_dist with a random sign; a random specimen per episode."""
        cfg = self.cfg
        z = dict(generator=generator, device=self.device)
        mag = 0.3 + 0.7 * torch.rand(n, **z)
        sign = torch.where(torch.rand(n, **z) < 0.5, 1.0, -1.0)
        spec_idx = torch.randint(0, self._pool.shape[0], (n,), **z)
        return mag * cfg.max_z_dist * sign, spec_idx

    def _obs(self, prev: torch.Tensor, cur: torch.Tensor,
             shift: torch.Tensor) -> torch.Tensor:
        plane = (shift / max(self.cfg.max_shift, 1e-9))[:, None, None]
        return torch.stack([prev, cur, plane.expand_as(cur)], dim=-1)

    # -- public API ------------------------------------------------------------
    def reset(self, seed: int = 0):
        """(state, obs): B fresh episodes from a generator at `seed`."""
        cfg = self.cfg
        gen = torch.Generator(self.device).manual_seed(seed)
        z, spec_idx = self.sample_start(gen, cfg.batch)
        frame = self.acquire(self._pool[spec_idx], z, gen)
        state = {"generator": gen, "z": z, "spec_idx": spec_idx,
                 "prev": frame,
                 "steps": torch.zeros(cfg.batch, dtype=torch.int32,
                                      device=self.device)}
        zero = torch.zeros(cfg.batch, device=self.device)
        return state, self._obs(frame, frame, zero)

    def step_draws(self, state: dict[str, Any]):
        """The auto-reset draws of one step: (start offsets, specimen
        indices) for every lane, used where a lane finishes."""
        return self.sample_start(state["generator"], self.cfg.batch)

    def step(self, state: dict[str, Any], shift, draws=None):
        """(new_state, obs_next, shaped, done, info) after shifting every
        lane by `shift` (B,); `draws` defaults to `step_draws(state)`."""
        cfg = self.cfg
        if draws is None:
            draws = self.step_draws(state)
        z0, spec0 = draws
        gen = state["generator"]
        shift = torch.clamp(torch.as_tensor(shift, dtype=torch.float32,
                                            device=self.device),
                            -cfg.max_shift, cfg.max_shift)
        prev_dist = state["z"].abs()
        z = state["z"] + shift
        dist = z.abs()
        frame = self.acquire(self._pool[state["spec_idx"]], z, gen)
        steps = state["steps"] + 1
        raw = torch.where(dist <= prev_dist, 1.0, -1.0)
        shaped = prev_dist - dist
        solved = dist < cfg.proximity
        done = solved | (steps >= cfg.max_episode_steps)
        obs = self._obs(state["prev"], frame, shift)

        # Auto-reset the finished lanes.
        frame0 = self.acquire(self._pool[spec0], z0, gen)
        new_state = {
            "generator": gen,
            "z": torch.where(done, z0, z),
            "spec_idx": torch.where(done, spec0, state["spec_idx"]),
            "prev": torch.where(done[:, None, None], frame0, frame),
            "steps": torch.where(done, 0, steps).to(torch.int32),
        }
        obs_next = torch.where(
            done[:, None, None, None],
            self._obs(frame0, frame0, torch.zeros_like(shift)), obs)
        info = {"distance": dist, "solved": solved, "raw_reward": raw}
        return new_state, obs_next, shaped, done, info

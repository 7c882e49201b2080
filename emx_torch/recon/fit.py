"""Differentiable exit-wave and aberration fitting, "psi-art" (port of
emx/recon/fit.py): Adam on a per-pixel amplitude and phase, axial
aberration coefficients to 6th order, per-slice defocus offsets and
per-slice translations against a measured focal series (reference
machine_learning/psi-art.py architecture:49-86, experiment:246-445). The
forward model is one batched computation over the slices.
"""

from __future__ import annotations

import dataclasses

import torch

from emx_torch.physics.ctf import Aberrations, full_ctf
from emx_torch.recon.align import fourier_shift


@dataclasses.dataclass(frozen=True)
class AberrationFitConfig:
    wavelength: float = 0.025
    px_dim: float = 1.0
    focal_spread: float = 0.0
    convergence_angle: float = 0.0
    steps: int = 400
    learning_rate: float = 0.02
    fit_aberrations: tuple[str, ...] = ("a20", "a22", "phi22", "a40")
    fit_shifts: bool = True


def _forward(params: dict, cfg: AberrationFitConfig, shape) -> torch.Tensor:
    """Predicted per-slice amplitudes |propagate(psi, CTF_i)|, (N, H, W)."""
    psi = params["amplitude"] * torch.exp(1j * params["phase"])
    dev = psi.device
    ab = Aberrations(**params["aberrations"])
    df = params["defocus"][:, None, None]
    # One CTF per slice: the aberrations with a20 + the slice's offset.
    ctf = full_ctf(shape, (cfg.px_dim, cfg.px_dim), cfg.wavelength,
                   ab.replace(a20=ab.a20 + df), focal_spread=cfg.focal_spread,
                   convergence_angle=cfg.convergence_angle, device=dev)
    out = torch.fft.ifft2(torch.fft.fft2(psi)[None] * ctf)
    if cfg.fit_shifts:
        out = fourier_shift(out, params["shift"])
    return torch.abs(out)


def fit_exit_wave(intensities: torch.Tensor, defocus_guess: torch.Tensor,
                  cfg: AberrationFitConfig = AberrationFitConfig()) -> dict:
    """Fit psi and the aberrations to a focal series of intensities
    (N, H, W) on its device. Returns {exit_wave, params, losses}."""
    n, h, w = intensities.shape
    dev = intensities.device
    target = torch.sqrt(torch.clamp(intensities.to(torch.float32), min=0.0))
    leaf = dict(dtype=torch.float32, device=dev)
    params = {
        "amplitude": torch.full((h, w), float(torch.mean(target)), **leaf),
        "phase": torch.zeros((h, w), **leaf),
        "defocus": torch.as_tensor(defocus_guess, **leaf).clone(),
        "shift": torch.zeros((n, 2), **leaf),
        "aberrations": {k: torch.zeros((), **leaf)
                        for k in cfg.fit_aberrations},
    }
    leaves = ([params[k] for k in ("amplitude", "phase", "defocus", "shift")]
              + list(params["aberrations"].values()))
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=cfg.learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for _ in range(cfg.steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((_forward(params, cfg, (h, w)) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        psi = params["amplitude"] * torch.exp(1j * params["phase"])
    return {"exit_wave": psi,
            "params": {k: ({a: t.detach() for a, t in v.items()}
                           if isinstance(v, dict) else v.detach())
                       for k, v in params.items()},
            "losses": losses}

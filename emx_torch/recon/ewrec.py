"""Exit-wavefunction reconstruction from a focal series (EWREC; port of
emx/recon/ewrec.py).

Gerchberg-Saxton iteration (reference misc_py/ewrec_class.py
reconstruct:481-513, reconstruction_loss:515-550,
defocus_initial_estimate:552-609):

  repeat num_iter times:
    exit_wave = mean_i propagate_to_focus(psi_i, defocus_i)
    psi_i     = amp_i / |propagate_back(exit_wave, defocus_i)| * propagate_back(...)

with amp_i = sqrt(I_i). The focal stack is one complex64 tensor on its
device and both sweeps are batched FFTs (cuFFT on a card). The mean over
slices is taken in Fourier space, where it is exactly fft2 of the exit
wave, so an iteration costs 2N FFTs instead of 3N + 1, as emx's does.
Every function runs on its input's device and is differentiable in the
defocuses (a real loss through complex FFTs, as jax.value_and_grad).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from emx_torch.physics.ctf import defocus_ctf, fftfreq
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EWRECConfig:
    wavelength: float = 0.025  # Angstrom (200 keV)
    px_dim: float = 1.0
    num_iter: int = 50
    pad_periods: float = 0.0
    series_type: str = "linear"  # defocus ramp: linear | quadratic


def _defocus_ramp(n: int, series_type: str,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """Signed ramp centred on the in-focus middle slice
    (reference defocus_initial_estimate:560-575)."""
    idx = torch.arange(n, dtype=torch.float32, device=device) - n // 2
    if series_type == "quadratic":
        return torch.sign(idx) * idx ** 2
    return idx


def _ctf_stack(defocuses: torch.Tensor, side: int, wavelength: float,
               px_dim: float, sign: float) -> torch.Tensor:
    """(N, side, side) complex64 kernels, one per defocus, on the
    defocuses' device."""
    return defocus_ctf(side, wavelength, sign * defocuses[:, None, None],
                       px_dim=px_dim)


def _as_defocuses(defocuses, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(defocuses, dtype=torch.float32,
                           device=like.device)


def reconstruct(amplitudes: torch.Tensor, defocuses,
                cfg: EWRECConfig) -> torch.Tensor:
    """Run the GS iteration. `amplitudes` (N, H, W) real (the square root
    of the measured intensities); returns the complex64 exit wave (H, W)."""
    n, h, w = amplitudes.shape
    if h != w:
        raise ValueError("EWREC operates on square crops")
    amps = amplitudes.to(torch.float32)
    dfs = _as_defocuses(defocuses, amps)
    to_focus = _ctf_stack(dfs, h, cfg.wavelength, cfg.px_dim, -1.0)
    to_plane = _ctf_stack(dfs, h, cfg.wavelength, cfg.px_dim, +1.0)
    psi = amps.to(torch.complex64)
    for _ in range(cfg.num_iter):
        exit_k = torch.mean(torch.fft.fft2(psi) * to_focus, dim=0)
        back = torch.fft.ifft2(exit_k[None] * to_plane)
        psi = back * (amps / torch.clamp(torch.abs(back), min=1e-12))
    return torch.fft.ifft2(torch.mean(torch.fft.fft2(psi) * to_focus, dim=0))


def deconstruct(exit_wave: torch.Tensor, defocuses,
                cfg: EWRECConfig) -> torch.Tensor:
    """Re-image the exit wave at each defocus: |propagate_back(wave, df_i)|."""
    h = exit_wave.shape[-1]
    dfs = _as_defocuses(defocuses, exit_wave)
    to_plane = _ctf_stack(dfs, h, cfg.wavelength, cfg.px_dim, +1.0)
    return torch.abs(torch.fft.ifft2(torch.fft.fft2(exit_wave)[None]
                                     * to_plane))


def reconstruction_loss(amplitudes: torch.Tensor, defocuses,
                        cfg: EWRECConfig) -> torch.Tensor:
    """mean_i mean((amp_i - s_i |reimage_i|)^2), s_i matching the means
    (ewrec_class.py:515-550, on square-root intensities)."""
    wave = reconstruct(amplitudes, defocuses, cfg)
    dec = deconstruct(wave, defocuses, cfg)
    scale = torch.mean(amplitudes, dim=(-2, -1), keepdim=True) / torch.clamp(
        torch.mean(dec, dim=(-2, -1), keepdim=True), min=1e-12)
    return torch.mean((amplitudes - scale * dec) ** 2)


def _weak_phase_system(intensities: torch.Tensor, defocuses,
                       cfg: EWRECConfig, tikhonov: float = 0.0):
    """The per-frequency 2-unknown least squares of the weak-phase model
    FT(I_i/mean - 1)(k) = -2 sin(chi_i) PHI(k) - 2 cos(chi_i) A(k)."""
    h = intensities.shape[-2]
    dev = intensities.device
    kx = fftfreq(h, cfg.px_dim, dev)
    k2 = kx[:, None] ** 2 + kx[None, :] ** 2
    dfs = _as_defocuses(defocuses, intensities)
    chi = math.pi * cfg.wavelength * dfs[:, None, None] * k2[None]
    rel = intensities / torch.mean(intensities, dim=(-2, -1),
                                   keepdim=True) - 1.0
    b = torch.fft.fft2(rel.to(torch.float32))
    s = -2.0 * torch.sin(chi)
    c = -2.0 * torch.cos(chi)
    ss = torch.sum(s * s, 0) + tikhonov
    sc = torch.sum(s * c, 0)
    cc = torch.sum(c * c, 0) + tikhonov
    sb = torch.sum(s * b, 0)
    cb = torch.sum(c * b, 0)
    return k2, b, s, c, ss, sc, cc, sb, cb


def weak_phase_residual(intensities: torch.Tensor, defocuses,
                        cfg: EWRECConfig, k_max: float = 0.4
                        ) -> torch.Tensor:
    """Relative residual (residual / signal power, over 0 < |k| < k_max)
    of the weak-phase linear imaging model solved per frequency over all
    slices: a sharp global minimum (0 noiseless) at the true focal step."""
    k2, b, s, c, ss, sc, cc, sb, cb = _weak_phase_system(
        intensities, defocuses, cfg)
    det = ss * cc - sc * sc
    det = torch.where(torch.abs(det) > 1e-9, det, torch.full_like(det, 1e-9))
    phi = (cc * sb - sc * cb) / det
    amp = (-sc * sb + ss * cb) / det
    pred = s * phi[None] + c * amp[None]
    mask = (k2 > 0) & (k2 < (k_max / cfg.px_dim) ** 2)
    resid = torch.sum(torch.abs(pred - b) ** 2 * mask[None])
    return resid / torch.clamp(torch.sum(torch.abs(b) ** 2 * mask[None]),
                               min=1e-12)


def weak_phase_reconstruct(intensities: torch.Tensor, defocuses,
                           cfg: EWRECConfig, k_max: float = 0.5,
                           tikhonov: float = 1e-3) -> torch.Tensor:
    """Linear (Tikhonov-regularised) weak-phase focal-series
    reconstruction: the per-frequency least squares for PHI(k), A(k),
    returned as the complex object (1 - a) exp(i phi)."""
    k2, b, s, c, ss, sc, cc, sb, cb = _weak_phase_system(
        intensities, defocuses, cfg, tikhonov)
    det = ss * cc - sc * sc
    phi_k = (cc * sb - sc * cb) / det
    a_k = (-sc * sb + ss * cb) / det
    mask = (k2 > 0) & (k2 < (k_max / cfg.px_dim) ** 2)
    phi = torch.fft.ifft2(phi_k * mask).real
    a = torch.fft.ifft2(a_k * mask).real
    return (1.0 - a) * torch.exp(1j * phi)


def defocus_search(amplitudes: torch.Tensor, cfg: EWRECConfig,
                   increments=None, num_candidates: int = 24,
                   min_incr: float = 1.0, max_incr: float = 512.0,
                   refine_rounds: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Estimate the per-slice defocus increment: the weak-phase residual
    over a log grid of candidate increments, narrowed around the argmin
    for `refine_rounds` rounds, never past the first grid's bounds (the
    reference sweeps its GS loss with bisection, ewrec_class.py:552-609).
    `amplitudes` are square-root intensities. Returns (best increment,
    defocuses), on the amplitudes' device."""
    n = amplitudes.shape[0]
    ramp = _defocus_ramp(n, cfg.series_type, amplitudes.device)
    intensities = amplitudes ** 2
    if increments is None:
        increments = np.exp(np.linspace(np.log(min_incr), np.log(max_incr),
                                        num_candidates))
    else:
        increments = np.asarray(increments)
    bound_lo = float(np.log(increments[0]))
    bound_hi = float(np.log(increments[-1]))
    lo, hi = bound_lo, bound_hi
    best = float(increments[0])
    for _ in range(refine_rounds):
        grid = np.exp(np.linspace(lo, hi, num_candidates))
        losses = torch.stack([
            weak_phase_residual(intensities, float(np.float32(inc)) * ramp,
                                cfg) for inc in grid]).cpu().numpy()
        best = float(grid[int(np.argmin(losses))])
        span = (hi - lo) / (num_candidates - 1)
        lo = max(bound_lo, float(np.log(best)) - span)
        hi = min(bound_hi, float(np.log(best)) + span)
    best_t = torch.tensor(best, dtype=torch.float32,
                          device=amplitudes.device)
    return best_t, best_t * ramp


def refine_defocuses(amplitudes: torch.Tensor, defocuses, cfg: EWRECConfig,
                     steps: int = 30, lr: float = 0.1) -> torch.Tensor:
    """Per-slice defocus refinement by Adam on the reconstruction loss
    (at most 10 GS iterations a loss), through the differentiable
    reconstruction: the replacement for the reference's scipy
    trust-krylov loop (ewrec_class.py:629-649)."""
    small = dataclasses.replace(cfg, num_iter=min(cfg.num_iter, 10))
    dfs = _as_defocuses(defocuses, amplitudes).clone().requires_grad_(True)
    opt = torch.optim.Adam([dfs], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        reconstruction_loss(amplitudes, dfs, small).backward()
        opt.step()
    return dfs.detach()


def ewrec(intensities, cfg: EWRECConfig = EWRECConfig(), defocuses=None,
          search: bool = True, device: str | torch.device | None = None
          ) -> dict:
    """The pipeline on a pre-aligned focal stack of measured intensities
    (N, H, W): amplitude = sqrt(I), an optional defocus search, the
    reconstruction. A tensor runs on its device; numpy goes to `device`
    (the card unless the caller asks for the CPU). Returns {exit_wave,
    amplitude, phase, defocuses, loss}."""
    if isinstance(intensities, torch.Tensor):
        x = intensities if device is None else intensities.to(
            resolve_device(device))
    else:
        x = torch.as_tensor(np.asarray(intensities),
                            device=resolve_device(device or "cuda"))
    amps = torch.sqrt(torch.clamp(x.to(torch.float32), min=0.0))
    if defocuses is None:
        if not search:
            raise ValueError("defocuses required when search=False")
        _, defocuses = defocus_search(amps, cfg)
    defocuses = _as_defocuses(defocuses, amps)
    with torch.no_grad():
        wave = reconstruct(amps, defocuses, cfg)
        loss = reconstruction_loss(amps, defocuses, cfg)
    return {"exit_wave": wave, "amplitude": torch.abs(wave),
            "phase": torch.angle(wave), "defocuses": defocuses,
            "loss": loss}

"""Contrast-transfer-function physics (port of part of emx/physics/ctf.py).

Only the simple defocus(+Cs) kernel of the EWREC reconstructor, which
the ctf micrograph family renders with (reference
misc_py/ewrec_class.py:423-448). Kernels are in fft layout (unshifted),
ready to multiply `torch.fft.fft2` output. The aberration polynomial,
envelopes and propagation are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import math

import torch


def fftfreq(n: int, d: float = 1.0,
            device: str | torch.device = "cpu") -> torch.Tensor:
    """float32 sample frequencies, computed as jnp.fft.fftfreq does:
    integers divided by n * d (torch's multiplies by the reciprocal)."""
    k = torch.cat([torch.arange(0, (n - 1) // 2 + 1),
                   torch.arange(-(n // 2), 0)]).to(device, torch.float32)
    return k / (d * n)


def spatial_frequencies(shape: tuple[int, int], sampling: tuple[float, float],
                        device: str | torch.device = "cpu"):
    """(kx, ky, k2) in fft layout for a real-space grid of `shape` pixels
    with `sampling` (pixel size) in the wavelength's length unit."""
    kx = fftfreq(shape[0], sampling[0], device)
    ky = fftfreq(shape[1], sampling[1], device)
    kx, ky = torch.meshgrid(kx, ky, indexing="ij")
    return kx, ky, kx ** 2 + ky ** 2


def defocus_ctf(side: int, wavelength: float,
                defocus_change: torch.Tensor | float, px_dim: float = 1.0,
                spher_aber_coeff: float | None = None,
                aperture_mask: torch.Tensor | None = None,
                device: str | torch.device = "cpu") -> torch.Tensor:
    """exp(i (pi lambda df |k|^2 [+ 0.5 pi lambda^3 Cs |k|^4])), complex64,
    (side, side). A tensor `defocus_change` sets the device; its trailing
    dims broadcast against the kernel's, so a (B, 1, 1) tensor gives B
    kernels."""
    if isinstance(defocus_change, torch.Tensor):
        device = defocus_change.device
    _, _, k2 = spatial_frequencies((side, side), (px_dim, px_dim), device)
    phase = (math.pi * wavelength * defocus_change) * k2
    if spher_aber_coeff is not None:
        phase = phase + (0.5 * math.pi * wavelength ** 3
                         * spher_aber_coeff) * k2 ** 2
    ctf = torch.exp(1j * phase.to(torch.float32)).to(torch.complex64)
    if aperture_mask is not None:
        ctf = ctf * aperture_mask
    return ctf

"""Contrast-transfer-function physics (port of emx/physics/ctf.py).

Both CTF models of the reference:
  * the simple defocus(+Cs) kernel of the EWREC reconstructor and of the
    ctf micrograph family (reference misc_py/ewrec_class.py:423-448);
  * the full 6th-order aberration polynomial chi with spatial, temporal
    and aperture envelopes of the differentiable exit-wave fitter
    (reference machine_learning/psi-art.py:88-223).

Kernels are in fft layout (unshifted), ready to multiply `torch.fft.fft2`
output, and differentiable in every tensor coefficient. The helpers take
a `device` (the CPU by default); callers pass their data's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# Aberration polynomial symbols: magnitude a_nm and azimuth phi_nm.
ABERRATION_MAGNITUDES = (
    "a20", "a22", "a31", "a33", "a40", "a42", "a44",
    "a51", "a53", "a55", "a60", "a62", "a64", "a66",
)
ABERRATION_ANGLES = (
    "phi22", "phi31", "phi33", "phi42", "phi44",
    "phi51", "phi53", "phi55", "phi62", "phi64", "phi66",
)


def energy_to_wavelength(v0_kev: float) -> float:
    """Relativistic electron wavelength in Angstroms for energy in keV
    (reference machine_learning/psi-art.py:88-95)."""
    m0 = 0.5109989461e3  # keV / c^2
    h = 4.135667662e-18  # keV * s
    c = 2.99792458e8  # m / s
    return h * c / math.sqrt(v0_kev * (2 * m0 + v0_kev)) * 1e10


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


@dataclasses.dataclass
class Aberrations:
    """Axial aberration coefficients up to 6th order (lengths in the
    wavelength's unit, angles in radians): floats or 0-dim tensors, which
    an optimizer may fit. a20 is defocus, a40 ~ Cs."""

    a20: torch.Tensor | float = 0.0
    a22: torch.Tensor | float = 0.0
    a31: torch.Tensor | float = 0.0
    a33: torch.Tensor | float = 0.0
    a40: torch.Tensor | float = 0.0
    a42: torch.Tensor | float = 0.0
    a44: torch.Tensor | float = 0.0
    a51: torch.Tensor | float = 0.0
    a53: torch.Tensor | float = 0.0
    a55: torch.Tensor | float = 0.0
    a60: torch.Tensor | float = 0.0
    a62: torch.Tensor | float = 0.0
    a64: torch.Tensor | float = 0.0
    a66: torch.Tensor | float = 0.0
    phi22: torch.Tensor | float = 0.0
    phi31: torch.Tensor | float = 0.0
    phi33: torch.Tensor | float = 0.0
    phi42: torch.Tensor | float = 0.0
    phi44: torch.Tensor | float = 0.0
    phi51: torch.Tensor | float = 0.0
    phi53: torch.Tensor | float = 0.0
    phi55: torch.Tensor | float = 0.0
    phi62: torch.Tensor | float = 0.0
    phi64: torch.Tensor | float = 0.0
    phi66: torch.Tensor | float = 0.0

    def replace(self, **kw) -> "Aberrations":
        return dataclasses.replace(self, **kw)


def aberration_chi(theta, phi, wavelength: float, ab: Aberrations):
    """Aberration phase chi(theta, phi): the 6th-order polynomial of
    reference machine_learning/psi-art.py:189-205."""
    cos = torch.cos
    chi = (
        (1 / 2.0) * (ab.a22 * cos(2 * (phi - ab.phi22)) + ab.a20) * theta**2
        + (1 / 3.0)
        * (ab.a33 * cos(3 * (phi - ab.phi33)) + ab.a31 * cos(phi - ab.phi31))
        * theta**3
        + (1 / 4.0)
        * (ab.a44 * cos(4 * (phi - ab.phi44))
           + ab.a42 * cos(2 * (phi - ab.phi42)) + ab.a40)
        * theta**4
        + (1 / 5.0)
        * (ab.a55 * cos(5 * (phi - ab.phi55))
           + ab.a53 * cos(3 * (phi - ab.phi53))
           + ab.a51 * cos(phi - ab.phi51))
        * theta**5
        + (1 / 6.0)
        * (ab.a66 * cos(6 * (phi - ab.phi66))
           + ab.a64 * cos(4 * (phi - ab.phi64))
           + ab.a62 * cos(2 * (phi - ab.phi62)) + ab.a60)
        * theta**6
    )
    return chi * (2.0 * math.pi / wavelength)


def _sign(v):
    return torch.sign(v) if isinstance(v, torch.Tensor) else \
        float((v > 0) - (v < 0))


def temporal_envelope(theta, wavelength: float, focal_spread):
    """Partial temporal coherence envelope
    (reference machine_learning/psi-art.py:171-176)."""
    return torch.exp(-_sign(focal_spread) * (
        0.5 * math.pi / wavelength * focal_spread * theta**2) ** 2)


def spatial_envelope(theta, phi, wavelength: float, ab: Aberrations,
                     convergence_angle):
    """Partial spatial coherence envelope from the gradient of chi
    (reference machine_learning/psi-art.py:132-169)."""
    sin, cos = torch.sin, torch.cos
    dchi_dq = (2 * math.pi / wavelength) * (
        (ab.a22 * cos(2 * (phi - ab.phi22)) + ab.a20) * theta
        + (ab.a33 * cos(3 * (phi - ab.phi33)) + ab.a31 * cos(phi - ab.phi31))
        * theta**2
        + (ab.a44 * cos(4 * (phi - ab.phi44))
           + ab.a42 * cos(2 * (phi - ab.phi42)) + ab.a40)
        * theta**3
        + (ab.a55 * cos(5 * (phi - ab.phi55))
           + ab.a53 * cos(3 * (phi - ab.phi53))
           + ab.a51 * cos(phi - ab.phi51))
        * theta**4
        + (ab.a66 * cos(6 * (phi - ab.phi66))
           + ab.a64 * cos(4 * (phi - ab.phi64))
           + ab.a62 * cos(2 * (phi - ab.phi62)) + ab.a60)
        * theta**5
    )
    dchi_dphi = (-2 * math.pi / wavelength) * (
        (1 / 2.0) * (2 * ab.a22 * sin(2 * (phi - ab.phi22))) * theta
        + (1 / 3.0)
        * (3 * ab.a33 * sin(3 * (phi - ab.phi33))
           + ab.a31 * sin(phi - ab.phi31))
        * theta**2
        + (1 / 4.0)
        * (4 * ab.a44 * sin(4 * (phi - ab.phi44))
           + 2 * ab.a42 * sin(2 * (phi - ab.phi42)))
        * theta**3
        + (1 / 5.0)
        * (5 * ab.a55 * sin(5 * (phi - ab.phi55))
           + 3 * ab.a53 * sin(3 * (phi - ab.phi53))
           + ab.a51 * sin(phi - ab.phi51))
        * theta**4
        + (1 / 6.0)
        * (6 * ab.a66 * sin(6 * (phi - ab.phi66))
           + 4 * ab.a64 * sin(4 * (phi - ab.phi64))
           + 2 * ab.a62 * sin(2 * (phi - ab.phi62)))
        * theta**5
    )
    return torch.exp(-_sign(convergence_angle) * (convergence_angle / 2.0)
                     ** 2 * (dchi_dq**2 + dchi_dphi**2))


def aperture_envelope(theta, aperture: float, aperture_edge: float = 0.0):
    """Objective-aperture mask with an optional raised-cosine edge
    (reference machine_learning/psi-art.py:178-187)."""
    inside = (theta <= aperture).to(torch.float32)
    if aperture_edge > 0.0:
        in_edge = (theta > aperture) & (theta < aperture + aperture_edge)
        edge = 0.5 * (1 + torch.cos(math.pi * (theta - aperture)
                                    / aperture_edge))
        return torch.where(in_edge, edge, inside)
    return inside


def full_ctf(shape: tuple[int, int], sampling: tuple[float, float],
             wavelength: float, ab: Aberrations, focal_spread=0.0,
             convergence_angle=0.0, aperture: float | None = None,
             aperture_edge: float = 0.0,
             device: str | torch.device = "cpu") -> torch.Tensor:
    """CTF = exp(-i chi) * temporal * spatial * aperture envelopes, in fft
    layout, complex64 (reference machine_learning/psi-art.py:207-223)."""
    kx, ky, k2 = spatial_frequencies(shape, sampling, device)
    theta = torch.sqrt(k2) * wavelength
    phi = torch.atan2(ky, kx)
    chi = aberration_chi(theta, phi, wavelength, ab)
    ctf = torch.exp(-1j * chi.to(torch.float32))
    ctf = ctf * temporal_envelope(theta, wavelength, focal_spread)
    ctf = ctf * spatial_envelope(theta, phi, wavelength, ab,
                                 convergence_angle)
    if aperture is not None:
        ctf = ctf * aperture_envelope(theta, aperture, aperture_edge)
    return ctf.to(torch.complex64)

"""Fresnel propagation of electron waves by CTF multiplication in Fourier
space, with optional zero padding against wrap-around (port of
emx/physics/propagate.py; reference misc_py/ewrec_class.py:108-119,
450-479). Kernels are in fft layout, the functions batch over leading
dims (a whole focal stack is one batched FFT), run on their input's
device, and are differentiable in the defocus.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emx_torch.physics.ctf import defocus_ctf


def _pad2(img: torch.Tensor, pad: int, value: complex = 0.0) -> torch.Tensor:
    if pad == 0:
        return img
    if value == 0:
        return F.pad(img, (0, pad, 0, pad))
    out = torch.full((*img.shape[:-2], img.shape[-2] + pad,
                      img.shape[-1] + pad), value, dtype=img.dtype,
                     device=img.device)
    out[..., :img.shape[-2], :img.shape[-1]] = img
    return out


def propagate_wave(img: torch.Tensor, ctf: torch.Tensor,
                   pad_periods: float = 0.0,
                   pad_value: complex = 0.0) -> torch.Tensor:
    """ifft2(fft2(pad(img)) * ctf)[..., :h, :w]; `ctf` sized for the
    padded grid, in fft layout."""
    h, w = img.shape[-2:]
    pad = int(round(pad_periods * h))
    padded = _pad2(img.to(torch.complex64), pad, pad_value)
    out = torch.fft.ifft2(torch.fft.fft2(padded) * ctf)
    return out[..., :h, :w]


def _defocus_tensor(defocus, like: torch.Tensor) -> torch.Tensor:
    """A defocus as a tensor on `like`'s device, shaped to broadcast over
    the last two dims (a (N,) tensor gives N kernels)."""
    d = torch.as_tensor(defocus, dtype=torch.float32, device=like.device)
    return d.reshape(*d.shape, 1, 1) if d.dim() else d


def propagate_to_focus(img: torch.Tensor, defocus, wavelength: float,
                       pad_periods: float = 0.0, px_dim: float = 1.0,
                       spher_aber_coeff: float | None = None
                       ) -> torch.Tensor:
    """Propagate a defocused wave back to the focal plane (defocus change
    -defocus; reference misc_py/ewrec_class.py:462-470)."""
    side = int(round((1.0 + pad_periods) * img.shape[-1]))
    ctf = defocus_ctf(side, wavelength, -_defocus_tensor(defocus, img),
                      px_dim=(1.0 + pad_periods) * px_dim,
                      spher_aber_coeff=spher_aber_coeff)
    return propagate_wave(img, ctf, pad_periods)


def propagate_back_to_defocus(exit_wave: torch.Tensor, defocus,
                              wavelength: float, pad_periods: float = 0.0,
                              px_dim: float = 1.0,
                              spher_aber_coeff: float | None = None
                              ) -> torch.Tensor:
    """Propagate the focal-plane exit wave out to a defocused plane
    (reference misc_py/ewrec_class.py:472-479). A (N,) `defocus` gives N
    planes of one wave."""
    side = int(round((1.0 + pad_periods) * exit_wave.shape[-1]))
    ctf = defocus_ctf(side, wavelength, _defocus_tensor(defocus, exit_wave),
                      px_dim=(1.0 + pad_periods) * px_dim,
                      spher_aber_coeff=spher_aber_coeff)
    return propagate_wave(exit_wave, ctf, pad_periods)


def propagate_stack_to_focus(stack: torch.Tensor, defocuses,
                             wavelength: float, pad_periods: float = 0.0,
                             px_dim: float = 1.0) -> torch.Tensor:
    """A whole focal series (N, H, W) to focus, slice i by defocuses[i]:
    one batched FFT."""
    return propagate_to_focus(stack, defocuses, wavelength, pad_periods,
                              px_dim)

"""Focal-series alignment (port of emx/recon/align.py): batched FFT phase
correlation with parabolic subpixel peaks, chained shifts, and gradient
affine registration (reference misc_py/ewrec_class.py
af_phase_corr:121-129, rel_pos_estimate:342-421;
misc_py/evolutionary_align.m:1-80, misc_py/warp_stack.m:21-60).

Every function runs on its input's device. `affine_warp` is
scipy/jax map_coordinates(order=1, mode="nearest") written as a bilinear
gather with clamped indices, so its gradient with respect to the
transform is jax's.
"""

from __future__ import annotations

import numpy as np
import torch

from emx_torch.physics.ctf import fftfreq


def phase_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Translation (dy, dx) with b(x) = a(x - d), subpixel by 3-point
    parabolic interpolation around the correlation peak. Leading dims
    batch: (..., H, W) pairs give (..., 2)."""
    fa = torch.fft.fft2(a)
    fb = torch.fft.fft2(b)
    cross = fa * torch.conj(fb)
    r = cross / torch.clamp(torch.abs(cross), min=1e-12)
    corr = torch.abs(torch.fft.ifft2(r))
    h, w = corr.shape[-2:]
    flat = corr.reshape(*corr.shape[:-2], h * w)
    idx = torch.argmax(flat, dim=-1)
    py, px = idx // w, idx % w

    def at(y, x):
        return torch.gather(flat, -1, ((y % h) * w + (x % w))[..., None]
                            )[..., 0]

    def parabolic(cm, c0, cp):
        denom = cm - 2 * c0 + cp
        ok = torch.abs(denom) > 1e-12
        return torch.where(ok, 0.5 * (cm - cp) / torch.where(
            ok, denom, torch.ones_like(denom)), torch.zeros_like(denom))

    c0 = at(py, px)
    dy = py + parabolic(at(py - 1, px), c0, at(py + 1, px))
    dx = px + parabolic(at(py, px - 1), c0, at(py, px + 1))
    dy = torch.where(dy > h / 2, dy - h, dy)
    dx = torch.where(dx > w / 2, dx - w, dx)
    return -torch.stack([dy, dx], dim=-1)


def fourier_shift(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Subpixel translation of the last two dims by a Fourier phase ramp
    (periodic boundary); `shift` (..., 2) batches with `img`. A real image
    gives a real result."""
    h, w = img.shape[-2:]
    ky = fftfreq(h, device=img.device)[:, None]
    kx = fftfreq(w, device=img.device)[None, :]
    s = torch.as_tensor(shift, device=img.device)
    phase = torch.exp(-2j * torch.pi * (s[..., 0, None, None] * ky
                                        + s[..., 1, None, None] * kx))
    out = torch.fft.ifft2(torch.fft.fft2(img) * phase.to(torch.complex64))
    return out if img.is_complex() else out.real


def relative_positions(stack: torch.Tensor) -> torch.Tensor:
    """Per-slice shifts relative to the middle image, chaining the
    neighbouring pairwise phase correlations outward from the centre
    (warp_stack.m semantics)."""
    n = stack.shape[0]
    mid = n // 2
    pair = phase_correlation(stack[:-1], stack[1:])  # (n-1, 2)
    zero = torch.zeros(2, dtype=pair.dtype, device=pair.device)
    shifts = [zero] * n
    acc = zero
    for i in range(mid + 1, n):
        acc = acc + pair[i - 1]
        shifts[i] = acc
    acc = zero
    for i in range(mid - 1, -1, -1):
        acc = acc - pair[i]
        shifts[i] = acc
    return torch.stack(shifts)


def align_stack(stack: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Align every slice to the middle one. Returns (aligned, shifts)."""
    shifts = relative_positions(stack)
    return fourier_shift(stack, -shifts), shifts


def affine_warp(img: torch.Tensor, matrix: torch.Tensor,
                offset: torch.Tensor) -> torch.Tensor:
    """Sample `img` (H, W) at A @ [y, x] + t (output coordinates to input
    coordinates), bilinearly, coordinates outside clamped to the edge:
    map_coordinates(order=1, mode="nearest")."""
    h, w = img.shape[-2:]
    dt = matrix.dtype
    yy, xx = torch.meshgrid(torch.arange(h, dtype=dt, device=img.device),
                            torch.arange(w, dtype=dt, device=img.device),
                            indexing="ij")
    coords = torch.stack([yy.reshape(-1), xx.reshape(-1)])
    src = matrix @ coords + offset[:, None]
    out = 0.0
    i0 = [torch.floor(c) for c in src]
    fr = [c - f for c, f in zip(src, i0)]
    i0 = [f.long() for f in i0]
    flat = img.reshape(-1)
    for dy in (0, 1):
        wy = fr[0] if dy else 1.0 - fr[0]
        iy = torch.clamp(i0[0] + dy, 0, h - 1)
        for dx in (0, 1):
            wx = fr[1] if dx else 1.0 - fr[1]
            ix = torch.clamp(i0[1] + dx, 0, w - 1)
            out = out + wy * wx * flat[iy * w + ix]
    return out.reshape(h, w)


def register_affine(fixed: torch.Tensor, moving: torch.Tensor,
                    steps: int = 200, learning_rate: float = 1e-2,
                    init_shift: torch.Tensor | None = None):
    """Gradient-descent affine registration of `moving` onto `fixed`
    (imregtform 'affine' of reference evolutionary_align.m:1-80): Adam on
    (A, t) minimising the interior-masked MSE, seeded by phase
    correlation. Returns (matrix, offset, warped)."""
    fixed = fixed.to(torch.float32)
    moving = moving.to(torch.float32)
    if init_shift is None:
        init_shift = phase_correlation(fixed, moving)
    matrix = torch.eye(2, dtype=torch.float32,
                       device=fixed.device).requires_grad_(True)
    offset = torch.as_tensor(init_shift, dtype=torch.float32,
                             device=fixed.device).clone().requires_grad_(True)
    h, w = fixed.shape
    m = int(0.05 * min(h, w)) + 1
    mask = torch.zeros((h, w), device=fixed.device)
    mask[m:-m, m:-m] = 1.0
    opt = torch.optim.Adam([matrix, offset], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        warped = affine_warp(moving, matrix, offset)
        loss = torch.sum(mask * (warped - fixed) ** 2) / torch.sum(mask)
        loss.backward()
        opt.step()
    matrix, offset = matrix.detach(), offset.detach()
    return matrix, offset, affine_warp(moving, matrix, offset)


def align_stack_affine(stack: torch.Tensor, steps: int = 150,
                       learning_rate: float = 1e-2):
    """Affine-align every slice to the middle one by composing pairwise
    registrations outward from the centre (warp_stack.m:21-60). Returns
    (aligned, transforms), each transform a (matrix, offset) mapping its
    slice onto the middle frame."""
    n = stack.shape[0]
    mid = n // 2
    dev = stack.device
    eye = (torch.eye(2, device=dev), torch.zeros(2, device=dev))
    transforms = [eye] * n

    def compose(a1, t1, a2, t2):
        # Sampling moving at A1 (A2 y + t2) + t1.
        return a1 @ a2, a1 @ t2 + t1

    for i in range(mid + 1, n):
        a, t, _ = register_affine(stack[i - 1], stack[i], steps,
                                  learning_rate)
        transforms[i] = compose(a, t, *transforms[i - 1])
    for i in range(mid - 1, -1, -1):
        a, t, _ = register_affine(stack[i + 1], stack[i], steps,
                                  learning_rate)
        transforms[i] = compose(a, t, *transforms[i + 1])
    aligned = torch.stack([affine_warp(stack[i], *transforms[i])
                           for i in range(n)])
    return aligned, transforms


def common_crop_slices(shifts, shape: tuple[int, int]) -> tuple[slice, slice]:
    """Pixel region valid in every shifted slice (warp_stack.m:21-60)."""
    s = (shifts.detach().cpu().numpy() if isinstance(shifts, torch.Tensor)
         else np.asarray(shifts))
    top = int(np.ceil(max(0, -s[:, 0].min())))
    bot = int(np.floor(min(shape[0], shape[0] - s[:, 0].max())))
    left = int(np.ceil(max(0, -s[:, 1].min())))
    right = int(np.floor(min(shape[1], shape[1] - s[:, 1].max())))
    return slice(top, max(top + 1, bot)), slice(left, max(left + 1, right))

"""Why the EWREC noiseless accuracy saturates (port of
emx/bench/ewrec_diagnosis.py).

Defocus transfers phase information as sin(chi), chi = pi lambda df k^2,
which vanishes toward k = 0: a focal series cannot determine the
near-DC band of the object's phase, whatever the algorithm. The rows, on
the accuracy bench's stack (np.random.default_rng(7), as emx draws it):

  1. gs_corr_vs_iters: noiseless correlation at 50/200/1000 GS
     iterations (a convergence problem rises, an information bound stays
     flat);
  2. weak_phase_corr: the linear Tikhonov inversion on the same stack;
  3. transfer_band_ceiling: the true wave with its phase and
     log-amplitude band-limited to the transferred frequencies;
  4. banded_object_gs_corr: an object whose phase lives in
     well-transferred bands must reconstruct to ~1.0;
  5. defocus_sensitivity: +-5% and +-20% defocus perturbations and
     refine_defocuses from the 5% one.

Usage: python -m emx_torch.bench.ewrec_diagnosis [side] [n_slices]
(--device=cpu runs on the CPU). Prints one JSON line.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from emx_torch.bench.ewrec_bench import (image_stack, interior_corr,
                                         smooth_object)
from emx_torch.recon.ewrec import (EWRECConfig, reconstruct,
                                   refine_defocuses, weak_phase_reconstruct)
from emx_torch.utils.device import resolve_device


def main(side: int = 256, n_slices: int = 15,
         device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    cfg = EWRECConfig(wavelength=0.025)
    rng = np.random.default_rng(7)
    phase = 1.2 * (smooth_object(rng, side) - 0.5)
    amp = 0.8 + 0.2 * smooth_object(rng, side)
    true_wave = (amp * np.exp(1j * phase)).astype(np.complex64)
    dfs_np = np.linspace(-700, 700, n_slices)
    dfs = torch.as_tensor(dfs_np, dtype=torch.float32, device=device)
    ints = image_stack(true_wave, dfs, cfg)
    ints_t = torch.as_tensor(ints, device=device)
    amps = torch.sqrt(torch.clamp(ints_t, min=0.0))
    true_t = torch.as_tensor(true_wave, device=device)

    def gs(a, d, it):
        with torch.no_grad():
            return reconstruct(a, d, EWRECConfig(wavelength=0.025,
                                                 num_iter=it))

    out: dict = {"metric": "ewrec_noiseless_diagnosis", "side": side,
                 "n_slices": n_slices, "defocus_range": [-700.0, 700.0]}
    out["gs_corr_vs_iters"] = {
        str(it): round(interior_corr(gs(amps, dfs, it), true_t, side), 4)
        for it in (50, 200, 1000)}
    wlin = weak_phase_reconstruct(ints_t, dfs, cfg)
    out["weak_phase_corr"] = round(interior_corr(wlin, true_t, side), 4)

    # Analytic transfer-band ceiling (numpy, as emx computes it).
    f = np.fft.fftfreq(side, d=cfg.px_dim)
    k2 = f[:, None] ** 2 + f[None, :] ** 2
    chi = (np.pi * cfg.wavelength
           * dfs.cpu().numpy()[:, None, None] * k2[None])
    strength = np.max(np.abs(np.sin(chi)), axis=0)
    ceilings = {}
    for thresh in (0.05, 0.1, 0.2):
        keep = (strength >= thresh) | (k2 == 0.0)
        logamp = np.log(np.maximum(np.abs(true_wave), 1e-6))
        ph_f = np.fft.ifft2(np.fft.fft2(phase) * keep).real
        la_f = np.fft.ifft2(np.fft.fft2(logamp) * keep).real
        ideal = (np.exp(la_f) * np.exp(1j * ph_f)).astype(np.complex64)
        ceilings[f"t{thresh}"] = round(interior_corr(
            torch.as_tensor(ideal, device=device), true_t, side), 4)
    out["transfer_band_ceiling"] = ceilings
    out["untransferred_energy_frac_t0.1"] = round(float(
        (np.abs(np.fft.fft2(phase)) ** 2 * (strength < 0.1)).sum()
        / (np.abs(np.fft.fft2(phase)) ** 2).sum()), 4)

    # Banded-object control: phase in well-transferred bands only.
    g = rng.normal(size=(side, side)) + 1j * rng.normal(size=(side, side))
    kmag = np.sqrt(k2)
    band = (kmag > 0.05) & (kmag < 0.15)
    bph = np.fft.ifft2(np.fft.fft2(np.real(np.fft.ifft2(
        g * band))) * band).real
    bph = 0.6 * bph / max(np.abs(bph).max(), 1e-9)
    banded = np.exp(1j * bph).astype(np.complex64)
    banded_t = torch.as_tensor(banded, device=device)
    bamps = torch.sqrt(torch.clamp(torch.as_tensor(
        image_stack(banded, dfs, cfg), device=device), min=0.0))
    out["banded_object_gs_corr"] = round(interior_corr(
        gs(bamps, dfs, 200), banded_t, side), 4)

    # Defocus-geometry sensitivity and refinement.
    sens = {"corr_true_df": out["banded_object_gs_corr"]}
    for frac in (0.05, 0.2):
        pert = dfs * (1.0 + torch.as_tensor(
            rng.uniform(-frac, frac, n_slices), dtype=torch.float32,
            device=device))
        sens[f"corr_perturbed_{int(frac * 100)}pct"] = round(interior_corr(
            gs(bamps, pert, 200), banded_t, side), 4)
        if frac == 0.05:
            refined = refine_defocuses(bamps, pert, cfg, steps=60, lr=2.0)
            sens["corr_refined_df"] = round(interior_corr(
                gs(bamps, refined, 200), banded_t, side), 4)
            sens["df_rms_before"] = round(float(torch.sqrt(torch.mean(
                (pert - dfs) ** 2))), 2)
            sens["df_rms_after"] = round(float(torch.sqrt(torch.mean(
                (refined - dfs) ** 2))), 2)
    out["defocus_sensitivity"] = sens
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    a = [x for x in sys.argv[1:] if not x.startswith("--")]
    dev = next((x.split("=", 1)[1] for x in sys.argv[1:]
                if x.startswith("--device=")), "cuda")
    main(int(a[0]) if a else 256, int(a[1]) if len(a) > 1 else 15,
         device=dev)

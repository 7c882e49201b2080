"""EWREC reconstruction throughput and accuracy (port of
emx/bench/ewrec_bench.py).

Throughput: GS iterations per second on the reference budget (512^2
crops, ~15 focal slices, 50 iterations; misc_py/ewrec_class.py:481-513,
651-666), three loops side by side on the stack's device:
  * the Fourier-averaged loop (emx_torch.recon.ewrec.reconstruct, 2N
    FFTs an iteration);
  * the naive loop (inverse FFT per slice, mean in real space, re-FFT the
    exit wave: 3N + 1 FFTs);
  * an FFT-only ceiling: the same 2N batched FFTs with one scale between
    them; a GS loop at this rate is FFT-bound.
Accuracy: the reconstruction's complex correlation with a known
synthetic exit wave under Poisson noise at falling dose, all drawn from
np.random.default_rng(7) as emx draws them.

Usage: python -m emx_torch.bench.ewrec_bench [n_slices] [side] [num_iter]
       python -m emx_torch.bench.ewrec_bench accuracy [n_slices] [side]
           [num_iter]
(--device=cpu runs on the CPU). Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from emx_torch.physics.propagate import propagate_back_to_defocus
from emx_torch.recon.ewrec import EWRECConfig, _ctf_stack, reconstruct
from emx_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_run(run, args, num_iter: int, n_calls: int = 5) -> float:
    """Iterations per second of `run(*args)` (a loop of num_iter), after
    one untimed call; each call ends in a host read, as emx's does."""
    float(run(*args))
    t0 = time.perf_counter()
    for _ in range(n_calls):
        acc = float(run(*args))
    dt = time.perf_counter() - t0
    if not np.isfinite(acc):
        raise RuntimeError("the timed loop gave a non-finite result")
    return num_iter * n_calls / dt


def measure(n_slices: int = 15, side: int = 512, num_iter: int = 50,
            device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    cfg = EWRECConfig(wavelength=0.025, num_iter=num_iter)
    rng = np.random.default_rng(0)
    amps = torch.as_tensor(rng.random((n_slices, side, side)),
                           dtype=torch.float32, device=device)
    dfs = torch.as_tensor(np.linspace(-700, 700, n_slices),
                          dtype=torch.float32, device=device)

    def stacks():
        return (_ctf_stack(dfs, side, cfg.wavelength, cfg.px_dim, -1.0),
                _ctf_stack(dfs, side, cfg.wavelength, cfg.px_dim, +1.0))

    @torch.no_grad()
    def run_fourier_avg(a):
        to_focus, to_plane = stacks()
        psi = a.to(torch.complex64)
        for _ in range(num_iter):
            exit_k = torch.mean(torch.fft.fft2(psi) * to_focus, dim=0)
            back = torch.fft.ifft2(exit_k[None] * to_plane)
            psi = back * (a / torch.clamp(torch.abs(back), min=1e-12))
        return torch.sum(torch.abs(psi))

    @torch.no_grad()
    def run_naive(a):
        to_focus, to_plane = stacks()
        psi = a.to(torch.complex64)
        for _ in range(num_iter):
            ew = torch.mean(torch.fft.ifft2(torch.fft.fft2(psi) * to_focus),
                            dim=0)
            back = torch.fft.ifft2(torch.fft.fft2(ew)[None] * to_plane)
            psi = back * (a / torch.clamp(torch.abs(back), min=1e-12))
        return torch.sum(torch.abs(psi))

    @torch.no_grad()
    def run_fft_only(a):
        psi = a.to(torch.complex64)
        for i in range(num_iter):
            psi = torch.fft.ifft2(torch.fft.fft2(psi) * (1.0 / (1 + i)))
        return torch.sum(torch.abs(psi))

    iters_fa = _time_run(run_fourier_avg, (amps,), num_iter)
    iters_naive = _time_run(run_naive, (amps,), num_iter)
    iters_fft = _time_run(run_fft_only, (amps,), num_iter)
    # One 2-D c64 FFT: 5 N log2 N per 1-D transform, rows and columns.
    fft_flops = 2 * side * 5.0 * side * np.log2(side)
    return {
        "metric": "ewrec_iters_per_s",
        "value": round(iters_fa, 2),
        "unit": f"GS iters/s ({n_slices}x{side}^2)",
        "full_reconstructions_per_s": round(iters_fa / num_iter, 3),
        "naive_loop_iters_per_s": round(iters_naive, 2),
        "fft_count_per_iter": {"fourier_avg": 2 * n_slices,
                               "naive": 3 * n_slices + 1},
        "fft_only_ceiling_iters_per_s": round(iters_fft, 2),
        "fraction_of_fft_ceiling": round(iters_fa / iters_fft, 3),
        "fft_gflops_implied": round(
            iters_fa * 2 * n_slices * fft_flops / 1e9, 1),
    }


def smooth_object(rng: np.random.Generator, side: int,
                  s: float = 8.0) -> np.ndarray:
    """Band-limited noise scaled to [0, 1] (emx's `smooth`)."""
    g = rng.normal(size=(side, side))
    f = np.fft.fftfreq(side)
    m = np.exp(-0.5 * (f[:, None] ** 2 + f[None, :] ** 2)
               * (s * side) ** 2 / 4)
    x = np.fft.ifft2(np.fft.fft2(g) * m).real
    return (x - x.min()) / max(x.max() - x.min(), 1e-9)


def image_stack(wave: np.ndarray, defocuses: torch.Tensor,
                cfg: EWRECConfig) -> np.ndarray:
    """|propagate_back(wave, df)|^2 at each defocus, computed on the
    defocuses' device; numpy float32 out."""
    w = torch.as_tensor(wave, device=defocuses.device)
    with torch.no_grad():
        return (torch.abs(propagate_back_to_defocus(
            w, defocuses, cfg.wavelength, px_dim=cfg.px_dim)) ** 2
        ).cpu().numpy()


def interior_corr(w1: torch.Tensor, w2: torch.Tensor, side: int) -> float:
    """|<w1, w2>| / (|w1| |w2|) over the interior (side/8 margins)."""
    c = side // 8
    a, b = w1[c:-c, c:-c], w2[c:-c, c:-c]
    num = torch.abs(torch.sum(a * torch.conj(b)))
    den = torch.sqrt(torch.sum(torch.abs(a) ** 2)
                     * torch.sum(torch.abs(b) ** 2))
    return float(num / torch.clamp(den, min=1e-12))


def accuracy_vs_dose(n_slices: int = 15, side: int = 256,
                     num_iter: int = 50,
                     device: str | torch.device = "cuda") -> dict:
    """Reconstruction fidelity against a known synthetic exit wave as the
    Poisson dose drops (the reference evaluates only on real stacks
    without ground truth, misc_py/ewrec_class.py:651-666)."""
    device = resolve_device(device)
    cfg = EWRECConfig(wavelength=0.025, num_iter=num_iter)
    rng = np.random.default_rng(7)
    phase = 1.2 * (smooth_object(rng, side) - 0.5)
    amp = 0.8 + 0.2 * smooth_object(rng, side)
    true_wave = (amp * np.exp(1j * phase)).astype(np.complex64)
    dfs = torch.as_tensor(np.linspace(-700, 700, n_slices),
                          dtype=torch.float32, device=device)
    ints = image_stack(true_wave, dfs, cfg)
    true_t = torch.as_tensor(true_wave, device=device)
    rows = {}
    for dose in (None, 1000.0, 250.0, 100.0, 25.0):
        if dose is None:
            noisy, key = ints, "noiseless"
        else:
            noisy = rng.poisson(ints / ints.mean() * dose) * ints.mean() / dose
            key = f"dose_{int(dose)}"
        a = torch.sqrt(torch.clamp(torch.as_tensor(
            noisy, dtype=torch.float32, device=device), min=0.0))
        with torch.no_grad():
            wave = reconstruct(a, dfs, cfg)
        rows[key] = round(interior_corr(wave, true_t, side), 4)
    return {"metric": "ewrec_accuracy_vs_dose", "n_slices": n_slices,
            "side": side, "num_iter": num_iter, "complex_corr": rows}


def main(n_slices: int = 15, side: int = 512, num_iter: int = 50,
         device: str | torch.device = "cuda") -> None:
    print(json.dumps(measure(n_slices, side, num_iter, device)))


if __name__ == "__main__":
    args = [x for x in sys.argv[1:] if not x.startswith("--")]
    dev = next((x.split("=", 1)[1] for x in sys.argv[1:]
                if x.startswith("--device=")), "cuda")
    if args and args[0] == "accuracy":
        print(json.dumps(accuracy_vs_dose(*[int(a) for a in args[1:]],
                                          device=dev)))
    else:
        main(*[int(a) for a in args], device=dev)

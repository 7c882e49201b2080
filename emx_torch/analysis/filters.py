"""Classical denoising filters and the NN-vs-classical comparison
(port of emx/analysis/filters.py).

The reference benchmarks its networks against Gaussian, bilateral,
median, Wiener, wavelet and Chambolle-TV filters (misc_py/
err_hist_maker.py:1-175). Every filter here takes a batch (..., H, W)
and treats each image on its own, as emx's filters do under `vmap`:
neighbourhoods are edge-clamped, the Wiener noise variance and the
wavelet threshold are per image. Arithmetic is float32 elementwise work
and reductions, no convolution, so no device takes TF32 for it.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from emx_torch.data.degrade import gaussian_blur


def gaussian_filter(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    return gaussian_blur(img, sigma)


def _neighborhood_stack(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(..., H, W, k*k) stack of shifted copies (edge-clamped), dy-major."""
    k = 2 * radius + 1
    h, w = img.shape[-2:]
    pad = F.pad(img.reshape(-1, 1, h, w), (radius,) * 4, mode="replicate")
    pad = pad.reshape(*img.shape[:-2], h + 2 * radius, w + 2 * radius)
    return torch.stack([pad[..., dy:dy + h, dx:dx + w]
                        for dy in range(k) for dx in range(k)], dim=-1)


def _median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jnp.median along `dim`: the middle value, or for an even count the
    midpoint of the two middle values (torch.median takes the lower)."""
    s = torch.sort(x, dim=dim).values
    n = s.shape[dim]
    hi = s.narrow(dim, n // 2, 1)
    if n % 2:
        return hi.squeeze(dim)
    return ((s.narrow(dim, n // 2 - 1, 1) + hi) / 2).squeeze(dim)


def median_filter(img: torch.Tensor, radius: int = 1) -> torch.Tensor:
    return _median(_neighborhood_stack(img, radius))


def bilateral_filter(img: torch.Tensor, radius: int = 2,
                     sigma_space: float = 1.5,
                     sigma_value: float = 0.1) -> torch.Tensor:
    k = 2 * radius + 1
    stack = _neighborhood_stack(img, radius)
    dy = torch.arange(k, device=img.device) - radius
    sp = torch.exp(-0.5 * (dy[:, None] ** 2 + dy[None, :] ** 2)
                   / sigma_space ** 2).reshape(-1).to(torch.float32)
    val = torch.exp(-0.5 * ((stack - img[..., None]) / sigma_value) ** 2)
    w = sp * val
    return (torch.sum(w * stack, dim=-1)
            / torch.clamp(torch.sum(w, dim=-1), min=1e-12))


def wiener_filter(img: torch.Tensor, radius: int = 1,
                  noise_var: float | None = None) -> torch.Tensor:
    """Local adaptive (Lee) Wiener filter, scipy.signal.wiener semantics;
    the noise variance defaults to each image's mean local variance."""
    stack = _neighborhood_stack(img, radius)
    mean = torch.mean(stack, dim=-1)
    var = torch.mean(stack ** 2, dim=-1) - mean ** 2
    nv = (torch.mean(var, dim=(-2, -1), keepdim=True) if noise_var is None
          else noise_var)
    gain = torch.clamp(var - nv, min=0.0) / torch.clamp(var, min=1e-12)
    return mean + gain * (img - mean)


def _haar2(img: torch.Tensor):
    p, q = img[..., 0::2, 0::2], img[..., 0::2, 1::2]
    r, s = img[..., 1::2, 0::2], img[..., 1::2, 1::2]
    a = (p + q + r + s) / 2
    h = (p - q + r - s) / 2
    v = (p + q - r - s) / 2
    d = (p - q - r + s) / 2
    return a, (h, v, d)


def _ihaar2(a: torch.Tensor, hvd) -> torch.Tensor:
    h, v, d = hvd
    out = a.new_empty((*a.shape[:-2], 2 * a.shape[-2], 2 * a.shape[-1]))
    out[..., 0::2, 0::2] = (a + h + v + d) / 2
    out[..., 0::2, 1::2] = (a - h + v - d) / 2
    out[..., 1::2, 0::2] = (a + h - v - d) / 2
    out[..., 1::2, 1::2] = (a - h - v + d) / 2
    return out


def wavelet_denoise(img: torch.Tensor, threshold: float | None = None,
                    levels: int = 3) -> torch.Tensor:
    """Haar soft-threshold denoising; by default each image's VisuShrink
    threshold from the MAD of its finest diagonal band."""
    coeffs = []
    a = img
    for _ in range(levels):
        a, hvd = _haar2(a)
        coeffs.append(hvd)
    if threshold is None:
        diag = coeffs[0][2].abs().flatten(-2)
        sigma = _median(diag)[..., None, None] / 0.6745
        n = torch.tensor(float(img.shape[-2] * img.shape[-1]),
                         device=img.device)
        threshold = sigma * torch.sqrt(2 * torch.log(n))

    def soft(x):
        return torch.sign(x) * torch.clamp(x.abs() - threshold, min=0.0)

    for hvd in reversed(coeffs):
        a = _ihaar2(a, tuple(soft(c) for c in hvd))
    return a


def chambolle_tv(img: torch.Tensor, weight: float = 0.1,
                 num_iter: int = 50) -> torch.Tensor:
    """Chambolle's projection algorithm for TV denoising
    (skimage.restoration.denoise_tv_chambolle semantics)."""
    tau = 0.125  # convergence requires tau <= 1/8 in 2D

    def grad(u):
        gy = torch.cat([u[..., 1:, :] - u[..., :-1, :],
                        torch.zeros_like(u[..., :1, :])], dim=-2)
        gx = torch.cat([u[..., :, 1:] - u[..., :, :-1],
                        torch.zeros_like(u[..., :, :1])], dim=-1)
        return gy, gx

    def div(py, px):
        dy = torch.cat([py[..., :1, :], py[..., 1:-1, :] - py[..., :-2, :],
                        -py[..., -2:-1, :]], dim=-2)
        dx = torch.cat([px[..., :, :1], px[..., :, 1:-1] - px[..., :, :-2],
                        -px[..., :, -2:-1]], dim=-1)
        return dy + dx

    py, px = torch.zeros_like(img), torch.zeros_like(img)
    for _ in range(num_iter):
        # Chambolle 2004: p <- (p + tau grad(div p - f/lambda)) /
        #                      (1 + tau |grad(div p - f/lambda)|)
        gy, gx = grad(div(py, px) - img / weight)
        denom = 1.0 + tau * torch.sqrt(gy ** 2 + gx ** 2)
        py = (py + tau * gy) / denom
        px = (px + tau * gx) / denom
    return img - weight * div(py, px)


DEFAULT_FILTERS = {
    "gaussian": lambda x: gaussian_filter(x, 1.0),
    "median": lambda x: median_filter(x, 1),
    "bilateral": lambda x: bilateral_filter(x),
    "wiener": lambda x: wiener_filter(x, 1),
    "wavelet": lambda x: wavelet_denoise(x),
    "tv_chambolle": lambda x: chambolle_tv(x, 0.1, 30),
}


def _per_image_psnr(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - truth) ** 2, dim=(-2, -1))
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))


def compare_denoisers(noisy: torch.Tensor, clean: torch.Tensor, nn_fn=None,
                      filters: dict | None = None,
                      per_image: bool = False) -> dict[str, dict]:
    """Per-method MSE/PSNR over a (B, H, W) batch, the err_hist_maker
    workload: each filter, `nn_fn` (batch -> batch) under "nn", and the
    noisy input under "identity". With `per_image=True` each entry also
    carries numpy `mses`/`psnrs` arrays."""
    filters = dict(filters or DEFAULT_FILTERS)
    noisy, clean = noisy.float(), clean.float()

    def evaluate(outs):
        outs = outs.float()
        per_mse = torch.mean((outs - clean) ** 2, dim=(-2, -1))
        per_psnr = _per_image_psnr(outs, clean)
        out = {"mse": float(per_mse.mean()), "psnr": float(per_psnr.mean())}
        if per_image:
            out["mses"] = per_mse.cpu().numpy()
            out["psnrs"] = per_psnr.cpu().numpy()
        return out

    results: dict[str, dict] = {}
    with torch.inference_mode():
        for name, fn in filters.items():
            results[name] = evaluate(fn(noisy))
        if nn_fn is not None:
            results["nn"] = evaluate(nn_fn(noisy))
        results["identity"] = evaluate(noisy)
    return results


def save_err_hists(results: dict, out_dir: str, bins: int = 50) -> dict:
    """Persist per-method loss arrays and histogram tables (the reference
    saves `*-losses.npy` per method, misc_py/err_hist_maker.py). Needs
    compare_denoisers(..., per_image=True) output. Returns
    {method: hist_counts}."""
    os.makedirs(out_dir, exist_ok=True)
    hists = {}
    all_mses = np.concatenate(
        [v["mses"] for v in results.values() if "mses" in v])
    edges = np.histogram_bin_edges(all_mses, bins=bins)
    for name, v in results.items():
        if "mses" not in v:
            continue
        np.save(os.path.join(out_dir, f"{name}-losses.npy"), v["mses"])
        counts, _ = np.histogram(v["mses"], bins=edges)
        hists[name] = counts
    np.savez(os.path.join(out_dir, "err_hist.npz"), edges=edges, **hists)
    return hists

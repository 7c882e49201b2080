"""Loss functions (port of emx/train/losses.py).

  * huberised_mse, the denoiser's capped loss: 1000 * mse below 1e-3,
    sqrt(1000 * mse) above (reference misc_py/denoiser-multi-gpu.py:
    772-773); `huberise` is the cap alone;
  * ssim / ms_ssim, structural similarity as used by the encoder-decoder
    experiments (reference misc_py/encoder-decoder.py:88-143), on
    (N, H, W, 1) batches as emx's. The 11x11 window is a float32
    convolution: on the card cuDNN takes TF32 for it unless
    `torch.backends.cudnn.allow_tf32` is off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def huberise(mse: torch.Tensor) -> torch.Tensor:
    """The cap of huberised_mse, applied to a mean squared error."""
    return torch.where(mse < 1e-3, 1000.0 * mse, torch.sqrt(1000.0 * mse))


def huberised_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return huberise(torch.mean((pred - target) ** 2))


# A loss of the batch's MSE alone says so: a data-parallel Trainer
# averages the ranks' MSEs (one scalar) and applies this to the mean.
huberised_mse.of_mse = huberise


def _gaussian_window(size: int, sigma: float,
                     device: torch.device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    w = torch.outer(g, g)
    return w / torch.sum(w)


def _filter2(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) -> valid convolution with `window`, as the reference
    tf_ssim does."""
    out = F.conv2d(img.permute(0, 3, 1, 2), window[None, None])
    return out.permute(0, 2, 3, 1)


def _ssim_terms(a, b, win, max_val):
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu1, mu2 = _filter2(a, win), _filter2(b, win)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter2(a * a, win) - mu1_sq
    s2 = _filter2(b * b, win) - mu2_sq
    s12 = _filter2(a * b, win) - mu12
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim_map, cs


def ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5,
         return_map: bool = False) -> torch.Tensor:
    """SSIM over (N, H, W, 1) batches, Gaussian 11x11 window, valid padding
    (semantics of reference misc_py/encoder-decoder.py tf_ssim:88-115)."""
    w = _gaussian_window(window_size, sigma, img1.device)
    ssim_map, _ = _ssim_terms(img1.float(), img2.float(), w, max_val)
    return ssim_map if return_map else torch.mean(ssim_map)


def _halve(x: torch.Tensor) -> torch.Tensor:
    """A 2x2 mean of (N, H, W, 1) with SAME padding (zeros at the far
    edge of an odd side), as emx's reduce_window sum / 4."""
    n, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    return x.reshape(n, h2, 2, w2, 2, c).sum(dim=(2, 4)) / 4.0


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0,
            weights: tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363,
                                          0.1333)) -> torch.Tensor:
    """Multi-scale SSIM with the standard 5-level weights
    (reference misc_py/encoder-decoder.py tf_ms_ssim:116-143)."""
    w = torch.tensor(weights, dtype=torch.float32, device=img1.device)
    win = _gaussian_window(11, 1.5, img1.device)
    mssim, mcs = [], []
    a, b = img1.float(), img2.float()
    for lvl in range(len(weights)):
        ssim_map, cs = _ssim_terms(a, b, win, max_val)
        mssim.append(torch.mean(ssim_map))
        mcs.append(torch.mean(cs))
        if lvl < len(weights) - 1:
            a, b = _halve(a), _halve(b)
    mssim_arr = torch.stack(mssim)
    mcs_arr = torch.stack(mcs)
    return torch.prod(torch.clamp(mcs_arr[:-1], min=1e-6) ** w[:-1]) \
        * torch.clamp(mssim_arr[-1], min=1e-6) ** w[-1]

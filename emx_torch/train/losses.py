"""Loss functions (port of emx/train/losses.py).

  * huberised_mse, the denoiser's capped loss: 1000 * mse below 1e-3,
    sqrt(1000 * mse) above (reference misc_py/denoiser-multi-gpu.py:
    772-773). `ssim` and `ms_ssim` are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch


def huberised_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return torch.where(mse < 1e-3, 1000.0 * mse, torch.sqrt(1000.0 * mse))

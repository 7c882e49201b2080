"""Learned denoising kernel dictionary with D4 radial weight tying (port
of emx/nn/kernels.py).

Rebuild of reference misc_py/noise-removal-kernels.py (make_layer:
108-230): a k x k convolution kernel whose weights are shared across the
8-fold dihedral symmetry (|x|, |y|, x<->y), so a k x k kernel has only
(k//2+1)(k//2+2)/2 unique parameters. A bank of (depth, width) variants
trains concurrently, each on its own loss (the reference's per-kernel
Adam, :434-449). The bank's parameters are disjoint and Adam is
elementwise, so one torch.optim.Adam over all of them, stepped on the
sum of the losses, is every variant's own Adam.

A kernel starts at 1 / k^2 everywhere and its bias at 0, as emx's does:
the bank's initial state has no random draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emx_torch.utils.device import resolve_device


def symmetry_index_map(size: int) -> np.ndarray:
    """(size, size) int map: entry -> index of its unique D4 orbit.
    Orbits are enumerated over 0 <= y <= x <= size//2 of the offset from
    centre, matching the reference's tying scheme."""
    if size % 2 != 1:
        raise ValueError(f"kernel size must be odd, got {size}")
    half = size // 2
    orbit, count = {}, 0
    for x in range(half + 1):
        for y in range(x + 1):
            orbit[(x, y)] = count
            count += 1
    out = np.zeros((size, size), np.int32)
    for i in range(size):
        for j in range(size):
            x, y = abs(i - half), abs(j - half)
            out[i, j] = orbit[(max(x, y), min(x, y))]
    return out


def num_unique(size: int) -> int:
    half = size // 2
    return (half + 1) * (half + 2) // 2


class SymmetricKernel(nn.Module):
    """One radially tied conv layer (+ bias), linear activation; flax's
    parameters `unique` (num_unique,) and `bias` (1,)."""

    def __init__(self, size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.size, self.dtype = size, dtype
        self.unique = nn.Parameter(torch.zeros(num_unique(size)))
        self.bias = nn.Parameter(torch.zeros(1))
        self.register_buffer("index", torch.from_numpy(
            symmetry_index_map(size).astype(np.int64)), persistent=False)
        self.init_from(None)

    def init_from(self, generator: torch.Generator | None) -> None:
        """emx's initial values (no draw): 1 / k^2 and 0."""
        with torch.no_grad():
            self.unique.fill_(1.0 / (self.size * self.size))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) or (B, H, W, 1) -> the same shape."""
        squeeze = x.dim() == 3
        if squeeze:
            x = x[..., None]
        kernel = self.unique[self.index].to(self.dtype)[None, None]
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), kernel,
                     padding=self.size // 2)
        out = y.permute(0, 2, 3, 1) + self.bias.to(self.dtype)
        return out[..., 0] if squeeze else out


class KernelStack(nn.Module):
    """`depth` tied kernels applied in sequence, relu between layers and
    a linear output."""

    def __init__(self, size: int = 3, depth: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        for d in range(depth):
            self.add_module(f"SymmetricKernel_{d}", SymmetricKernel(size,
                                                                    dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for d in range(self.depth):
            x = self._modules[f"SymmetricKernel_{d}"](x)
            if d < self.depth - 1:
                x = torch.relu(x)
        return x


@dataclasses.dataclass
class KernelBank:
    """A grid of KernelStack variants trained concurrently, each on its
    own MSE; `models` holds (depth, width, KernelStack) in emx's order."""

    depths: tuple[int, ...] = (1, 2, 3)
    widths: tuple[int, ...] = (3, 5, 7)
    learning_rate: float = 1e-3
    device: str | torch.device = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        self.models = [(d, w, KernelStack(size=w, depth=d).to(dev))
                       for d in self.depths for w in self.widths]

    def init(self) -> dict:
        """The bank's state: its modules (reset to emx's initial values)
        and one Adam over all of them."""
        for _, _, m in self.models:
            for k in m.modules():
                if isinstance(k, SymmetricKernel):
                    k.init_from(None)
        params = [p for _, _, m in self.models for p in m.parameters()]
        return {"models": [m for _, _, m in self.models],
                "opt": torch.optim.Adam(params, lr=self.learning_rate)}

    def make_step(self):
        """step(state, noisy, clean) -> (state, losses (n_models,)): one
        Adam step of every variant on its own MSE."""
        def step(state, noisy, clean):
            opt = state["opt"]
            losses = torch.stack([torch.mean((m(noisy) - clean) ** 2)
                                  for m in state["models"]])
            opt.zero_grad(set_to_none=True)
            losses.sum().backward()
            opt.step()
            return state, losses.detach()

        return step

    def labels(self) -> list[str]:
        return [f"depth{d}_width{w}" for d, w, _ in self.models]

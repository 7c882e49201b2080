"""Fresnel-fringe presence classifier (port of emx/scope/classifier.py).

Capability rebuild of reference em_env/fresnel_transfer_cnn.py (a VGG19
transfer-learned binary classifier for fringe presence). No pretrained
VGG exists offline; a compact CNN trains directly on simulator-labelled
data (in-focus vs defocused frames from emx_torch.scope.sim).

The training draws its batch indices from numpy as emx's does; the
network starts from flax's default distributions at `seed` (not flax's
numbers), and `load_classifier` carries emx's trained parameters in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from emx_torch.nn.blocks import Conv, Dense, Named
from emx_torch.nn.init import init_parameters
from emx_torch.scope.dqn import flat_flax_params
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.utils.device import resolve_device


class FringeClassifier(Named):
    """Conv(f, 3x3, stride 2, SAME) + relu per feature, mean over space,
    Dense(64) + relu, Dense(1): the logit that fringes are present."""

    def __init__(self, features: tuple[int, ...] = (16, 32, 64),
                 cin: int = 1, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.convs, c = [], cin
        for f in features:
            self.convs.append(self._add(Conv(c, f, 3, strides=2,
                                             dtype=dtype)))
            c = f
        self.hidden = self._add(Dense(c, 64, dtype=dtype))
        self.head = self._add(Dense(64, 1, dtype=dtype))
        self.to(device=resolve_device(device), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        m = self._modules
        for name in self.convs:
            x = torch.relu(m[name](x))
        h = torch.relu(m[self.hidden](x.mean((1, 2))))
        return m[self.head](h)[..., 0]


@dataclasses.dataclass
class FringeTrainResult:
    params: dict            # flax's flat names and layouts, numpy
    losses: list
    accuracy: float
    model: FringeClassifier | None = None


def load_classifier(model: FringeClassifier, params) -> FringeClassifier:
    """emx's trained parameters (`FringeTrainResult.params`, a flax tree,
    or flat `"Conv_0/kernel"` names) into `model`; returns `model`."""
    return load_flax_params(model, flat_flax_params(params))


def collect_fringe_dataset(scope, n_per_class: int = 64,
                           defocus_range=(1.5, 3.0), seed: int = 0):
    """Label frames from the simulator: z at optimum -> 0, defocused -> 1."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for _ in range(n_per_class):
        scope.x = float(rng.uniform(0, 128))
        scope.y = float(rng.uniform(0, 128))
        scope.z = scope.optimal_z + rng.uniform(-0.05, 0.05)
        imgs.append(scope.acquire())
        labels.append(0.0)
        sign = 1 if rng.random() > 0.5 else -1
        scope.z = scope.optimal_z + sign * rng.uniform(*defocus_range)
        imgs.append(scope.acquire())
        labels.append(1.0)
    return np.stack(imgs).astype(np.float32), np.asarray(labels, np.float32)


def classifier_step(model: FringeClassifier, opt: torch.optim.Optimizer,
                    x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One Adam step on the mean sigmoid cross-entropy (optax's
    sigmoid_binary_cross_entropy); the loss before the step."""
    loss = F.binary_cross_entropy_with_logits(model(x), y.to(x.dtype))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def train_fringe_classifier(
    imgs: np.ndarray, labels: np.ndarray, steps: int = 200,
    learning_rate: float = 1e-3, batch_size: int = 32, seed: int = 0,
    device: str | torch.device = "cuda",
) -> FringeTrainResult:
    device = resolve_device(device)
    model = FringeClassifier(device=device)
    init_parameters(model, torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate)
    x_all = torch.as_tensor(np.asarray(imgs, np.float32), device=device)
    y_all = torch.as_tensor(np.asarray(labels, np.float32), device=device)

    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(imgs), batch_size)).to(
            device)
        losses.append(classifier_step(model, opt, x_all[idx], y_all[idx]))
    losses = [float(v) for v in torch.stack(losses).cpu()] if losses else []

    with torch.no_grad():
        logits = model(x_all)
    acc = float(((logits > 0) == (y_all > 0.5)).float().mean())
    return FringeTrainResult(params=to_flax_params(model)[0], losses=losses,
                             accuracy=acc, model=model)

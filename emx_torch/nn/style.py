"""Neural style transfer (port of emx/nn/style.py): optimisation-based
(Gatys) and fast feed-forward restyling with multi-style guidance.

Capability rebuild of reference machine_learning/style_transfer.py:
38-416 (Gram-matrix optimisation, one content layer, five style layers
weighted 0.2 each) and guided-fast-style-fusion.py:52-951 (a
feed-forward restyling network trained against multi-style Gram losses).

The feature extractor is a fixed random-weight multi-scale conv pyramid
(`ConvPyramidFeatures`), no pretrained network. emx initialises it from
jax.random.key(seed) and draws the canvas noise from the same key; no
seed of the port's reproduces those draws. So `make_feature_fn` takes
the pyramid's parameters (emx's flat flax dict, e.g. from
docs/runs/port_style/inputs.npz) and `transfer_style` takes the noise;
without them the port draws its own from a torch.Generator seeded by
`seed` (other numbers, the same distributions).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from emx_torch.analysis.stats import gram_matrix
from emx_torch.nn.blocks import (Conv, Named, Norm, SepConvBlock,
                                 XceptionMiddleBlock, _avg_pool_2x2_same,
                                 _resize_bilinear)
from emx_torch.utils.device import resolve_device

STYLE_LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")


class ConvPyramidFeatures(nn.Module):
    """Fixed 5-level conv / average-pool pyramid (VGG-like topology),
    the style and content feature basis; children conv1..conv5."""

    def __init__(self, features: tuple[int, ...] = (32, 64, 128, 128, 128),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.features = features
        c = cin
        for i, f in enumerate(features, start=1):
            self.add_module(f"conv{i}", Conv(c, f, 3))
            c = f
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        if x.dim() == 2:
            x = x[None, ..., None]
        elif x.dim() == 3:
            x = x[..., None]
        acts, h = {}, x
        for i in range(1, len(self.features) + 1):
            h = torch.relu(self._modules[f"conv{i}"](h))
            acts[f"conv{i}_1"] = h
            if i < len(self.features):
                h = _avg_pool_2x2_same(h)
        acts["content"] = acts["conv4_1"]
        return acts


def make_feature_fn(size: int, seed: int = 0,
                    params: dict[str, np.ndarray] | None = None,
                    device: str | torch.device = "cuda") -> Callable:
    """img -> feature dict of a frozen ConvPyramidFeatures: emx's
    parameters when `params` (flat flax dict) is given, else the port's
    initialisation from `seed`. `size` is emx's argument (its init
    traces a size x size image); the pyramid takes any size."""
    from emx_torch.nn.init import init_parameters
    from emx_torch.serve.convert import load_flax_params

    model = ConvPyramidFeatures(device="cpu")
    if params is not None:
        load_flax_params(model, params)
    else:
        init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(resolve_device(device)).requires_grad_(False)

    def feature_fn(img: torch.Tensor) -> dict[str, torch.Tensor]:
        return model(img)

    feature_fn.model = model
    return feature_fn


def style_content_loss(feats: dict, content_feats: dict,
                       style_grams: list[dict],
                       style_weights: Sequence[float],
                       rel_styles: Sequence[float], content_weight: float,
                       style_weight: float) -> torch.Tensor:
    c, p = feats["content"], content_feats["content"]
    content_loss = 0.5 * torch.sum((c - p) ** 2) / c.numel()
    style_loss = 0.0
    for grams, rel in zip(style_grams, rel_styles):
        for layer, w in zip(STYLE_LAYERS, style_weights):
            g = gram_matrix(feats[layer][0])
            style_loss = style_loss + rel * w * torch.mean(
                (g - grams[layer]) ** 2)
    return content_weight * content_loss + style_weight * style_loss


@dataclasses.dataclass
class StyleTransferConfig:
    content_weight: float = 1.0
    style_weight: float = 200.0
    style_layer_weights: tuple[float, ...] = (0.2, 0.2, 0.2, 0.2, 0.2)
    steps: int = 300
    learning_rate: float = 0.05
    input_noise: float = 0.1
    seed: int = 0


def _style_grams(style_list, feature_fn) -> list[dict]:
    out = []
    for s in style_list:
        f = feature_fn(s)
        out.append({layer: gram_matrix(f[layer][0])
                    for layer in STYLE_LAYERS})
    return out


def _as_list(styles) -> list:
    return list(styles) if isinstance(styles, (list, tuple)) else [styles]


def transfer_style(content: torch.Tensor, styles,
                   cfg: StyleTransferConfig = StyleTransferConfig(),
                   feature_fn: Callable | None = None,
                   mask: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """Optimise an image to carry `content`'s structure with the style
    statistics of `styles` (Gatys; reference transfer_style:38-281), by
    Adam on the canvas content + input_noise * noise. `noise` (the
    content's shape, N(0, 1)) defaults to a draw from a generator seeded
    by cfg.seed on the content's device; `mask`: 1.0 pixels are
    conserved from the content image. Runs on the content's device."""
    content = torch.as_tensor(content, dtype=torch.float32)
    dev = content.device
    style_list = [torch.as_tensor(s, dtype=torch.float32).to(dev)
                  for s in _as_list(styles)]
    feature_fn = feature_fn or make_feature_fn(content.shape[-1], cfg.seed,
                                               device=dev)
    with torch.no_grad():
        content_feats = feature_fn(content)
        style_grams = _style_grams(style_list, feature_fn)
    rel = [1.0 / len(style_list)] * len(style_list)
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        noise = torch.randn(content.shape, generator=gen, device=dev)
    canvas = (content + cfg.input_noise * noise.to(dev)).detach()
    canvas.requires_grad_(True)
    opt = torch.optim.Adam([canvas], lr=cfg.learning_rate)
    for _ in range(cfg.steps):
        loss = style_content_loss(feature_fn(canvas), content_feats,
                                  style_grams, cfg.style_layer_weights, rel,
                                  cfg.content_weight, cfg.style_weight)
        if mask is not None:
            loss = loss + 10.0 * torch.mean(mask * (canvas - content) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return torch.clamp(canvas.detach(), 0.0, 1.0)


class RestyleNet(Named):
    """Feed-forward restyling network (guided-fast-style-fusion
    architecture:52-288 shape): strided encoder, residual middle,
    resize-conv decoder, sigmoid output."""

    def __init__(self, features: tuple[int, int, int] = (32, 64, 128),
                 num_blocks: int = 3, device: str | torch.device = "cuda",
                 cin: int = 1):
        super().__init__()
        f0, f1, f2 = features
        self.enc = [self._add(SepConvBlock(cin, f0, norm="instance")),
                    self._add(SepConvBlock(f0, f1, strides=2,
                                           norm="instance")),
                    self._add(SepConvBlock(f1, f2, strides=2,
                                           norm="instance"))]
        self.middle = [self._add(XceptionMiddleBlock(f2, norm="instance"))
                       for _ in range(num_blocks)]
        self.ups, c = [], f2
        for f in (f1, f0):
            self.ups.append((self._add(Conv(c, f, 3)),
                             self._add(Norm("instance", f, torch.float32))))
            c = f
        self.head = self._add(Conv(c, 1, 3))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        m = self._modules
        squeeze = x.dim() == 3
        h = x[..., None] if squeeze else x
        for n in self.enc + self.middle:
            h = m[n](h, train)
        for conv, norm in self.ups:
            h = _resize_bilinear(h, (2 * h.shape[1], 2 * h.shape[2]))
            h = torch.relu(m[norm](m[conv](h), train))
        out = torch.sigmoid(m[self.head](h))
        return out[..., 0] if squeeze else out


def train_fast_restyler(content_batches, styles,
                        cfg: StyleTransferConfig = StyleTransferConfig(),
                        num_steps: int = 200,
                        feature_fn: Callable | None = None,
                        net: RestyleNet | None = None,
                        device: str | torch.device = "cuda"):
    """Train RestyleNet against the multi-style Gram losses
    (guided-fast-style-fusion train loop:290-951). `content_batches`
    yields (B, H, W) arrays; `net` defaults to a RestyleNet initialised
    from cfg.seed by the port. Returns (net, losses)."""
    from emx_torch.nn.init import init_parameters

    dev = resolve_device(device)
    it = iter(content_batches)
    first = torch.as_tensor(next(it), dtype=torch.float32).to(dev)
    feature_fn = feature_fn or make_feature_fn(first.shape[-1], cfg.seed,
                                               device=dev)
    with torch.no_grad():
        style_grams = _style_grams(
            [torch.as_tensor(s, dtype=torch.float32).to(dev)
             for s in _as_list(styles)], feature_fn)
    rel = [1.0 / len(style_grams)] * len(style_grams)
    if net is None:
        net = init_parameters(RestyleNet(device="cpu"),
                              torch.Generator().manual_seed(cfg.seed))
    net = net.to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=cfg.learning_rate)

    batch, losses = first, []
    for _ in range(num_steps):
        out = net(batch, train=True)
        loss = 0.0
        for i in range(batch.shape[0]):
            with torch.no_grad():
                cfeats = feature_fn(batch[i])
            loss = loss + style_content_loss(
                feature_fn(out[i]), cfeats, style_grams,
                cfg.style_layer_weights, rel, cfg.content_weight,
                cfg.style_weight)
        loss = loss / batch.shape[0]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        try:
            nxt = next(it)
        except StopIteration:
            it = iter(content_batches)
            nxt = next(it)
        batch = torch.as_tensor(nxt, dtype=torch.float32).to(dev)
    return net, losses

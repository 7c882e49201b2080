"""Latent autoencoder (port of emx/nn/latent.py): encode a micrograph to
a compact dense latent, decode back.

Reference family machine_learning/usupervised_latency.py
generator_architecture:205-455: a strided separable encoder with
leaky-relu activations, a global-average dense bottleneck with tanh and
dropout, a resize-conv decoder; instance norm (the .pyw variant).

Dropout keeps each latent unit where a uniform draw is below 1 - rate
and scales it by 1 / (1 - rate), as flax's nn.Dropout does. The draws
differ by platform, so `forward` takes the keep mask from the caller
(`dropout_keep`) or draws it from `generator`.
"""

from __future__ import annotations

import dataclasses

import torch

from emx_torch.nn.blocks import (Conv, Dense, Named, Norm, SepConvBlock,
                                 _resize_bilinear, leaky_relu)
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LatentAEConfig:
    enc_features: tuple[int, ...] = (32, 64, 128, 256, 512, 768, 1024)
    head_features: tuple[int, int] = (1536, 2048)
    latent_dim: int = 64
    dec_features: tuple[int, ...] = (512, 256, 128, 64, 32, 16, 16)
    dropout_rate: float = 0.25
    norm: str = "instance"
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls) -> "LatentAEConfig":
        return cls(enc_features=(8, 8, 16), head_features=(16, 16),
                   latent_dim=8, dec_features=(8, 8, 8))


class LatentEncoder(Named):
    def __init__(self, config: LatentAEConfig, cin: int = 1):
        super().__init__()
        self.config = cfg = config
        kw = dict(norm=cfg.norm, dtype=cfg.dtype, activation=leaky_relu)
        self.blocks, c = [], cin
        for f in cfg.enc_features:
            self.blocks.append(self._add(SepConvBlock(c, f, strides=2, **kw)))
            c = f
        for f in cfg.head_features:
            self.blocks.append(self._add(SepConvBlock(c, f, **kw)))
            c = f
        self.Dense_0 = Dense(c, cfg.latent_dim, cfg.dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_keep: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.config
        if x.dim() == 3:
            x = x[..., None]
        h = x.to(cfg.dtype)
        for n in self.blocks:
            h = self._modules[n](h, train)
        z = torch.tanh(self.Dense_0(torch.mean(h, dim=(1, 2))))
        if train and cfg.dropout_rate > 0:
            keep_prob = 1.0 - cfg.dropout_rate
            if dropout_keep is None:
                dropout_keep = torch.rand(z.shape, generator=generator,
                                          device=z.device) < keep_prob
            z = torch.where(dropout_keep, z / keep_prob, torch.zeros_like(z))
        return z.float()


class LatentDecoder(Named):
    BASE = 4

    def __init__(self, config: LatentAEConfig):
        super().__init__()
        self.config = cfg = config
        c = cfg.dec_features[0]
        self.Dense_0 = Dense(cfg.latent_dim, self.BASE * self.BASE * c,
                             cfg.dtype)
        self.ups = []
        for f in cfg.dec_features:
            self.ups.append((self._add(Conv(c, f, 3, dtype=cfg.dtype)),
                             self._add(Norm(cfg.norm, f, cfg.dtype))))
            c = f
        self.head = self._add(Conv(c, 1, 3, dtype=cfg.dtype))

    def forward(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg, m = self.config, self._modules
        c0 = cfg.dec_features[0]
        h = self.Dense_0(z.to(cfg.dtype))
        h = leaky_relu(h.reshape(z.shape[0], self.BASE, self.BASE, c0))
        for conv, norm in self.ups:
            hh, ww = h.shape[1], h.shape[2]
            h = _resize_bilinear(h, (2 * hh, 2 * ww)).to(cfg.dtype)
            h = leaky_relu(m[norm](m[conv](h), train))
        return torch.tanh(m[self.head](h).float())


class LatentAutoencoder(torch.nn.Module):
    """encode -> decode; output resolution 4 * 2^len(dec_features)."""

    def __init__(self, config: LatentAEConfig = LatentAEConfig(),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.config = config
        self.encoder = LatentEncoder(config, cin)
        self.decoder = LatentDecoder(config)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False,
                dropout_keep: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        squeeze = x.dim() == 3
        z = self.encoder(x, train, dropout_keep, generator)
        out = self.decoder(z, train)
        return out[..., 0] if squeeze else out

    def encode(self, x: torch.Tensor, train: bool = False, **kw
               ) -> torch.Tensor:
        return self.encoder(x, train, **kw)

    def decode(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder(z, train)

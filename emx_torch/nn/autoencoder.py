"""Autoencoder family (port of emx/nn/autoencoder.py).

  * SmallAutoencoder: three stride-2 separable convs (64/128/256), a
    16-channel bottleneck block, three transpose-conv ups, a 3x3 head
    with an instance-norm output (reference misc_py/autoencoder.py
    architecture:83-176).
  * XceptionAutoencoder: aligned-Xception entry/middle/exit encoder +
    ASPP + a transpose-conv decoder to the full resolution (reference
    misc_py/modified_Xception.py:194-655).
  * UnsupervisedEmbedder: Xception trunk -> global average pool -> two
    dense layers -> N-way softmax, trained with the batch-paired cosine
    metric loss (reference misc_py/unsupervised_Xception.py:435-457,
    677-727).

Children carry flax's names (`Conv_0`, `SepConvBlock_3`,
`XceptionMiddleBlock_0`, `ASPP_0`, `Dense_1`, ...), so
emx_torch.serve.convert moves emx's parameters across. Activations are
NHWC; parameters stay float32 and are cast to the config's dtype at
each layer, as flax's `dtype=` does. Parameters start at zero:
load_flax_params fills them from emx's, init_parameters from a seed.
"""

from __future__ import annotations

import dataclasses

import torch

from emx_torch.nn.blocks import (ASPP, Conv, DeconvBlock, Dense, Named, Norm,
                                 SepConvBlock, XceptionMiddleBlock, relu6)
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SmallAEConfig:
    features: tuple[int, int, int] = (64, 128, 256)
    bottleneck: int = 16
    norm: str = "batch"
    dtype: torch.dtype = torch.float32


class SmallAutoencoder(Named):
    def __init__(self, config: SmallAEConfig = SmallAEConfig(),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.config = cfg = config
        kw = dict(norm=cfg.norm, dtype=cfg.dtype)
        self.enc, c = [], cin
        for f in cfg.features:
            self.enc.append(self._add(SepConvBlock(c, f, strides=2, **kw)))
            c = f
        self.enc.append(self._add(SepConvBlock(c, cfg.bottleneck, **kw)))
        self.dec, c = [], cfg.bottleneck
        for f in reversed(cfg.features):
            self.dec.append(self._add(DeconvBlock(c, f, norm=cfg.norm,
                                                  mode="transpose",
                                                  dtype=cfg.dtype)))
            c = f
        self.head = (self._add(Conv(c, 1, 3, dtype=cfg.dtype)),
                     self._add(Norm("instance", 1, cfg.dtype)))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W) or (B, H, W, C) -> the same shape with one channel,
        float32."""
        m = self._modules
        squeeze = x.dim() == 3
        if squeeze:
            x = x[..., None]
        h = x.to(self.config.dtype)
        for n in self.enc + self.dec:
            h = m[n](h, train)
        conv, norm = (m[n] for n in self.head)
        out = norm(conv(h)).float()
        return out[..., 0] if squeeze else out

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Bottleneck features (B, H/8, W/8, bottleneck) for retrieval and
        clustering. emx's `encode` returns flax's captured intermediates
        of a whole forward; the bottleneck is the one a caller uses."""
        h = (x[..., None] if x.dim() == 3 else x).to(self.config.dtype)
        for n in self.enc:
            h = self._modules[n](h, False)
        return h


@dataclasses.dataclass(frozen=True)
class XceptionAEConfig:
    entry_features: tuple[int, ...] = (128, 256, 728)
    num_middle_blocks: int = 16
    exit_features: tuple[int, int] = (728, 1024)
    aspp_out: int = 256
    decoder_features: tuple[int, ...] = (256, 128, 64, 32)
    norm: str = "group"
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls) -> "XceptionAEConfig":
        return cls(entry_features=(8, 12, 16), num_middle_blocks=1,
                   exit_features=(16, 16), aspp_out=8,
                   decoder_features=(8, 8))


class XceptionAutoencoder(Named):
    def __init__(self, config: XceptionAEConfig = XceptionAEConfig(),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.config = cfg = config
        kw = dict(norm=cfg.norm, dtype=cfg.dtype)
        self.stem = (self._add(Conv(cin, 32, 3, strides=2, dtype=cfg.dtype)),
                     self._add(Norm(cfg.norm, 32, cfg.dtype)),
                     self._add(SepConvBlock(32, 64, **kw)))
        self.entry, c = [], 64
        for f in cfg.entry_features:
            self.entry.append((self._add(SepConvBlock(c, f, **kw)),
                               self._add(SepConvBlock(f, f, **kw)),
                               self._add(SepConvBlock(f, f, strides=2, **kw)),
                               self._add(Conv(c, f, 1, strides=2,
                                              dtype=cfg.dtype))))
            c = f
        self.middle = [self._add(XceptionMiddleBlock(c, **kw))
                       for _ in range(cfg.num_middle_blocks)]
        f0, f1 = cfg.exit_features
        self.exit = (self._add(SepConvBlock(c, f0, **kw)),
                     self._add(SepConvBlock(f0, f1, strides=2, **kw)),
                     self._add(Conv(c, f1, 1, strides=2, dtype=cfg.dtype)))
        self.aspp = self._add(ASPP(f1, f1, cfg.aspp_out, **kw))
        # One up per downsample: the stem, each entry block, the exit.
        num_ups = 1 + len(cfg.entry_features) + 1
        feats = list(cfg.decoder_features)
        while len(feats) < num_ups:
            feats.append(feats[-1])
        self.dec, c = [], cfg.aspp_out
        for f in feats[:num_ups]:
            self.dec.append(self._add(DeconvBlock(c, f, norm=cfg.norm,
                                                  mode="transpose",
                                                  dtype=cfg.dtype)))
            c = f
        self.head = self._add(Conv(c, 1, 3, dtype=cfg.dtype))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W) or (B, H, W, C) -> one channel in [0, 1], float32."""
        m = self._modules
        squeeze = x.dim() == 3
        if squeeze:
            x = x[..., None]
        x = x.to(self.config.dtype)
        conv, norm, sep = (m[n] for n in self.stem)
        h = sep(relu6(norm(conv(x), train)), train)
        for a0, a1, a2, res in self.entry:
            a = m[a2](m[a1](m[a0](h, train), train), train)
            h = a + m[res](h)
        for n in self.middle:
            h = m[n](h, train)
        a0, a1, res = self.exit
        h = m[a1](m[a0](h, train), train) + m[res](h)
        h = m[self.aspp](h, train)
        for n in self.dec:
            h = m[n](h, train)
        out = torch.clamp(m[self.head](h).float(), 0.0, 1.0)
        return out[..., 0] if squeeze else out


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    entry_features: tuple[int, ...] = (128, 256, 728)
    num_middle_blocks: int = 8
    fc_features: int = 4096
    embedding_dim: int = 30
    norm: str = "group"
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls) -> "EmbedderConfig":
        return cls(entry_features=(8, 12, 16), num_middle_blocks=1,
                   fc_features=32, embedding_dim=6)


class UnsupervisedEmbedder(Named):
    def __init__(self, config: EmbedderConfig = EmbedderConfig(),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.config = cfg = config
        kw = dict(norm=cfg.norm, dtype=cfg.dtype)
        self.stem = (self._add(Conv(cin, 32, 3, strides=2, dtype=cfg.dtype)),
                     self._add(Norm(cfg.norm, 32, cfg.dtype)))
        self.entry, c = [], 32
        for f in cfg.entry_features:
            self.entry.append((self._add(SepConvBlock(c, f, **kw)),
                               self._add(SepConvBlock(f, f, strides=2, **kw)),
                               self._add(Conv(c, f, 1, strides=2,
                                              dtype=cfg.dtype))))
            c = f
        self.middle = [self._add(XceptionMiddleBlock(c, **kw))
                       for _ in range(cfg.num_middle_blocks)]
        self.fc = (self._add(Dense(c, cfg.fc_features, cfg.dtype)),
                   self._add(Dense(cfg.fc_features, cfg.fc_features,
                                   cfg.dtype)))
        self.logits = self._add(Dense(cfg.fc_features, cfg.embedding_dim,
                                      cfg.dtype))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False,
                features: bool = False) -> torch.Tensor:
        """Softmax embedding (B, embedding_dim), or with `features` the
        penultimate dense features (B, fc_features), float32."""
        m = self._modules
        if x.dim() == 3:
            x = x[..., None]
        x = x.to(self.config.dtype)
        conv, norm = (m[n] for n in self.stem)
        h = relu6(norm(conv(x), train))
        for a0, a1, res in self.entry:
            h = m[a1](m[a0](h, train), train) + m[res](h)
        for n in self.middle:
            h = m[n](h, train)
        h = torch.mean(h, dim=(1, 2))
        for n in self.fc:
            h = torch.relu(m[n](h))
        if features:
            return h.float()
        return torch.softmax(m[self.logits](h).float(), dim=-1)


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median of a 1-D tensor: the mean of the two middle values of
    an even count (torch.median takes the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def embedder_metric_loss(embeddings: torch.Tensor) -> torch.Tensor:
    """Batch-paired cosine similarity minus median dissimilarity
    (reference unsupervised_Xception.py:677-727): consecutive pairs
    (2i, 2i+1) are two crops of the same micrograph; pull their
    embeddings together while pushing apart the median off-pair
    similarity."""
    e = embeddings / torch.clamp(
        torch.linalg.vector_norm(embeddings, dim=-1, keepdim=True), min=1e-8)
    sim = e @ e.T
    n = e.shape[0]
    idx = torch.arange(n // 2, device=e.device)
    pair_sim = sim[2 * idx, 2 * idx + 1]
    mask = ~torch.eye(n, dtype=torch.bool, device=e.device)
    mask[2 * idx, 2 * idx + 1] = False
    mask[2 * idx + 1, 2 * idx] = False
    med_off = _median(sim[mask])
    return torch.mean(1.0 - pair_sim) + torch.clamp(med_off, min=0.0)

"""Shared-manifold domain translator, TEM <-> STEM (port of
emx/nn/manifold.py).

Capability rebuild of reference misc_py/shared_manifold.pyw: a Distiller
per domain (encoder into a shared code space), a Generator per domain
(decoder from the shared code back to the domain), per-domain
discriminators, and a "confuser" head that adversarially removes domain
information from the shared code (shared_manifold.pyw:945-1035). Losses:
within-domain reconstruction (distillation MSE), confusion toward 0.5
for the distillers, and the confuser's own BCE.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from emx_torch.nn.blocks import (Conv, Dense, Named, Norm, SepConvBlock,
                                 _resize_bilinear, relu6)
from emx_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ManifoldConfig:
    enc_features: tuple[int, ...] = (32, 64, 128)
    code_features: int = 128
    dec_features: tuple[int, ...] = (64, 32)
    disc_features: tuple[int, ...] = (32, 64, 128)
    norm: str = "instance"
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls) -> "ManifoldConfig":
        return cls(enc_features=(8, 8), code_features=8,
                   dec_features=(8,), disc_features=(8, 8))

    def scaled(self, scale: float) -> "ManifoldConfig":
        """emx.bench.zoo_ladder's widths at `scale` (1.0 = reference)."""
        def s(v):
            return max(8, int(v * scale))

        return dataclasses.replace(
            self, enc_features=tuple(s(f) for f in (32, 64, 128)),
            code_features=s(128),
            dec_features=tuple(s(f) for f in (64, 32)),
            disc_features=tuple(s(f) for f in (32, 64, 128)))


def _strided_blocks(owner: Named, cfg: ManifoldConfig, features, cin: int):
    names, c = [], cin
    for f in features:
        names.append(owner._add(SepConvBlock(c, f, strides=2, norm=cfg.norm,
                                             dtype=cfg.dtype)))
        c = f
    return names, c


class Distiller(Named):
    """Domain encoder into the shared manifold code (tanh, float32)."""

    def __init__(self, cfg: ManifoldConfig, cin: int = 1):
        super().__init__()
        self.config = cfg
        self.blocks, c = _strided_blocks(self, cfg, cfg.enc_features, cin)
        self.Conv_0 = Conv(c, cfg.code_features, 1, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = (x[..., None] if x.dim() == 3 else x).to(self.config.dtype)
        for n in self.blocks:
            h = self._modules[n](h, train)
        return torch.tanh(self.Conv_0(h).float())


class DomainGenerator(Named):
    """Decoder from the shared code into one domain: (B, H, W) in (0, 1)."""

    def __init__(self, cfg: ManifoldConfig):
        super().__init__()
        self.config = cfg
        ups = len(cfg.enc_features)
        feats = list(cfg.dec_features) + [cfg.dec_features[-1]] * ups
        self.ups, c = [], cfg.code_features
        for i in range(ups):
            self.ups.append((self._add(Conv(c, feats[i], 3, dtype=cfg.dtype)),
                             self._add(Norm(cfg.norm, feats[i], cfg.dtype))))
            c = feats[i]
        self.head = self._add(Conv(c, 1, 3, dtype=cfg.dtype))

    def forward(self, code: torch.Tensor, train: bool = False) -> torch.Tensor:
        m, h = self._modules, code.to(self.config.dtype)
        for conv, norm in self.ups:
            h = _resize_bilinear(h, (2 * h.shape[1], 2 * h.shape[2]))
            h = relu6(m[norm](m[conv](h), train))
        return torch.sigmoid(m[self.head](h).float())[..., 0]


class DomainDiscriminator(Named):
    def __init__(self, cfg: ManifoldConfig, cin: int = 1,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.config = cfg
        self.blocks, c = _strided_blocks(self, cfg, cfg.disc_features, cin)
        self.Dense_0 = Dense(c, 1, None)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = (x[..., None] if x.dim() == 3 else x).to(self.config.dtype)
        for n in self.blocks:
            h = self._modules[n](h, train)
        return torch.sigmoid(
            self.Dense_0(torch.mean(h, dim=(1, 2))).float())[..., 0]


class Confuser(nn.Module):
    """Predicts which domain a shared code came from; the distillers are
    trained to defeat it (shared_manifold.pyw:945-1035)."""

    def __init__(self, cfg: ManifoldConfig):
        super().__init__()
        self.Dense_0 = Dense(cfg.code_features, 64, None)
        self.Dense_1 = Dense(64, 1, None)

    def forward(self, code: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.Dense_0(torch.mean(code, dim=(1, 2))))
        return torch.sigmoid(self.Dense_1(h).float())[..., 0]


class SharedManifoldTranslator(nn.Module):
    """Both domains: translate A->B via distill_a + gen_b."""

    def __init__(self, config: ManifoldConfig = ManifoldConfig.tiny(),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.config = config
        self.distill_a = Distiller(config, cin)
        self.distill_b = Distiller(config, cin)
        self.gen_a = DomainGenerator(config)
        self.gen_b = DomainGenerator(config)
        self.confuser = Confuser(config)
        self.to(resolve_device(device))

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                train: bool = False) -> dict:
        code_a = self.distill_a(a, train)
        code_b = self.distill_b(b, train)
        return {"recon_a": self.gen_a(code_a, train),
                "recon_b": self.gen_b(code_b, train),
                "a_to_b": self.gen_b(code_a, train),
                "b_to_a": self.gen_a(code_b, train),
                "code_a": code_a, "code_b": code_b,
                "domain_pred_a": self.confuser(code_a),
                "domain_pred_b": self.confuser(code_b)}


def confuser_bce(pred_a: torch.Tensor, pred_b: torch.Tensor) -> torch.Tensor:
    eps = 1e-7
    pa = torch.clamp(pred_a, eps, 1 - eps)
    pb = torch.clamp(pred_b, eps, 1 - eps)
    return -torch.mean(torch.log(1 - pa)) - torch.mean(torch.log(pb))


def manifold_losses(out: dict, a: torch.Tensor, b: torch.Tensor) -> dict:
    """Distillation + confusion losses. The confuser itself trains on
    `confuser_bce`; the distillers receive `confusion` (toward 0.5),
    returned apart for the two optimizers."""
    recon = (torch.mean((out["recon_a"] - a) ** 2)
             + torch.mean((out["recon_b"] - b) ** 2))
    eps = 1e-7
    pa = torch.clamp(out["domain_pred_a"], eps, 1 - eps)
    pb = torch.clamp(out["domain_pred_b"], eps, 1 - eps)
    return {"recon": recon,
            "confuser_bce": confuser_bce(out["domain_pred_a"],
                                         out["domain_pred_b"]),
            "confusion": torch.mean((pa - 0.5) ** 2)
            + torch.mean((pb - 0.5) ** 2)}

"""Nested VAE-GAN ("VAE-GAN-in-VAE-GAN") representation learner (port of
emx/nn/vaegan.py).

Capability rebuild of reference misc_py/ga-vae.py: an outer
encoder/decoder autoencodes the micrograph; an inner VAE bottlenecks the
outer code; a spectral-normalised critic provides a Wasserstein loss with
gradient penalty; a siamese encoder makes augmented views (D4 / polar
warp / cutout) embed together; the losses combine with the reference
weights (ga-vae.py:852-870: wass 1, gp 10, rot-invariance 1, siamese 1,
mse 1).

Spectral normalisation is emx's own power iteration on a stored `u`
(one step a call, ga-vae.py:79-113): v = W u / |W u|, u' = W^T v / |.|,
sigma = v W u', the weight divided by sigma. It is not
torch.nn.utils.spectral_norm, which normalises the other axis. `u` is a
buffer of flax's `spectral` collection, so emx's values come across
through emx_torch.serve.convert; a fresh port model draws its own from
init_parameters' generator (emx draws N(0, 1) from jax.random.key(0)).
A call with `update=True` stores u' (flax's mutable "spectral").

Every random value of a step comes from the caller, so tests can feed
emx's: the inner VAE's eps (`vaegan_draws`), the cutout corners and the
gradient penalty's mixing weights.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from emx_torch.nn.blocks import (Conv, Dense, Named, Norm, SepConvBlock,
                                 _resize_bilinear, conv_nhwc, leaky_relu,
                                 relu6)
from emx_torch.nn.init import _TRUNC_STD, truncated_normal_
from emx_torch.utils.device import resolve_device


def _power_step(w: torch.Tensor, u: torch.Tensor):
    """(sigma, u') of a (n, features) matrix: one power iteration."""
    v = w @ u
    v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
    u_new = w.T @ v
    u_new = u_new / torch.clamp(torch.linalg.vector_norm(u_new), min=1e-12)
    return v @ w @ u_new, u_new


class _Spectral(nn.Module):
    """`kernel` (flax's layout) and its power-iteration vector `u`."""

    FLAX_COLLECTIONS = {"u": "spectral"}

    def __init__(self, shape: tuple[int, ...]):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.register_buffer("u", torch.zeros(shape[-1]))

    def init_from(self, generator: torch.Generator) -> None:
        """flax's lecun_normal kernel; u ~ N(0, 1) (the port's own draw)."""
        fan_in = math.prod(self.kernel.shape[:-1])
        with torch.no_grad():
            truncated_normal_(self.kernel, math.sqrt(1.0 / fan_in)
                              / _TRUNC_STD, generator)
            self.u.copy_(torch.randn(self.u.shape, generator=generator,
                                     dtype=torch.float64).to(self.u.dtype))

    def normalised(self, update: bool) -> torch.Tensor:
        w = self.kernel
        # A copy: the product's backward keeps u, which `update` moves.
        sigma, u_new = _power_step(w.reshape(-1, w.shape[-1]),
                                   self.u.clone())
        if update:
            with torch.no_grad():
                self.u.copy_(u_new)
        return w / torch.clamp(sigma, min=1e-12)


class SNDense(_Spectral):
    def __init__(self, cin: int, features: int):
        super().__init__((cin, features))

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        return x @ self.normalised(update)


class SNConv(_Spectral):
    """SAME conv without bias; `kernel` (k, k, cin, features)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 strides: int = 1):
        super().__init__((kernel, kernel, cin, features))
        self.strides = strides

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        k = self.normalised(update)
        return conv_nhwc(x, k.permute(3, 2, 0, 1), self.strides)


@dataclasses.dataclass(frozen=True)
class VAEGANConfig:
    enc_features: tuple[int, ...] = (64, 128, 256, 512)
    inner_latent: int = 64
    dec_features: tuple[int, ...] = (256, 128, 64, 32)
    critic_features: tuple[int, ...] = (64, 128, 256, 512)
    siamese_dim: int = 64
    norm: str = "instance"
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls) -> "VAEGANConfig":
        return cls(enc_features=(8, 8, 16), inner_latent=8,
                   dec_features=(8, 8, 8), critic_features=(8, 8),
                   siamese_dim=8)

    def scaled(self, scale: float) -> "VAEGANConfig":
        """emx.bench.zoo_ladder's widths at `scale` (1.0 = reference)."""
        def s(v, lo=8):
            return max(lo, int(v * scale))

        return dataclasses.replace(
            self, enc_features=tuple(s(f) for f in (64, 128, 256, 512)),
            inner_latent=s(64),
            dec_features=tuple(s(f) for f in (256, 128, 64, 32)),
            critic_features=tuple(s(f) for f in (64, 128, 256, 512)),
            siamese_dim=s(64))


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x[..., None] if x.dim() == 3 else x


class OuterEncoder(Named):
    def __init__(self, cfg: VAEGANConfig, cin: int = 1, depth=None):
        super().__init__()
        self.config = cfg
        self.blocks, c = [], cin
        for f in cfg.enc_features[:depth]:
            self.blocks.append(self._add(SepConvBlock(
                c, f, strides=2, norm=cfg.norm, dtype=cfg.dtype)))
            c = f
        self.out_features = c

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = _to_nhwc(x).to(self.config.dtype)
        for n in self.blocks:
            h = self._modules[n](h, train)
        return h


class InnerVAE(nn.Module):
    """VAE over the pooled outer code: (z, mu, logvar, recon_code)."""

    def __init__(self, cfg: VAEGANConfig, code: int):
        super().__init__()
        # flax's nn.Dense() without a dtype: the input's, promoted.
        self.Dense_0 = Dense(code, cfg.inner_latent, None)
        self.Dense_1 = Dense(code, cfg.inner_latent, None)
        self.Dense_2 = Dense(cfg.inner_latent, code, None)

    def forward(self, code: torch.Tensor, eps: torch.Tensor | None,
                train: bool = False):
        pooled = torch.mean(code, dim=(1, 2))
        mu, logvar = self.Dense_0(pooled), self.Dense_1(pooled)
        z = mu + torch.exp(0.5 * logvar) * eps if train else mu
        up = self.Dense_2(z)
        return z, mu, logvar, code + up[:, None, None, :]


class OuterDecoder(Named):
    def __init__(self, cfg: VAEGANConfig, code: int):
        super().__init__()
        self.config = cfg
        self.ups, c = [], code
        for f in cfg.dec_features:
            self.ups.append((self._add(Conv(c, f, 3, dtype=cfg.dtype)),
                             self._add(Norm(cfg.norm, f, cfg.dtype))))
            c = f
        self.head = self._add(Conv(c, 1, 3, dtype=cfg.dtype))

    def forward(self, code: torch.Tensor, train: bool = False):
        m, h = self._modules, code
        for conv, norm in self.ups:
            h = _resize_bilinear(h, (2 * h.shape[1], 2 * h.shape[2]))
            h = relu6(m[norm](m[conv](h), train))
        return torch.sigmoid(m[self.head](h).float())


class SpectralCritic(Named):
    """Wasserstein critic with spectral-normalised convs (ga-vae
    discriminator_architecture:572-708). `update` stores every layer's
    new u (flax's mutable "spectral")."""

    def __init__(self, config: VAEGANConfig = VAEGANConfig.tiny(),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.config = config
        self.convs, c = [], cin
        for f in config.critic_features:
            self.convs.append(self._add(SNConv(c, f, strides=2)))
            c = f
        self.SNDense_0 = SNDense(c, 1)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        h = _to_nhwc(x)
        for n in self.convs:
            h = leaky_relu(self._modules[n](h, update))
        return self.SNDense_0(torch.mean(h, dim=(1, 2)), update)[..., 0]


class SiameseEncoder(OuterEncoder):
    def __init__(self, cfg: VAEGANConfig, cin: int = 1):
        super().__init__(cfg, cin, depth=3)
        self.Dense_0 = Dense(self.out_features, cfg.siamese_dim, None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.Dense_0(torch.mean(super().forward(x, train), dim=(1, 2)))


class NestedVAEGAN(nn.Module):
    def __init__(self, config: VAEGANConfig = VAEGANConfig.tiny(),
                 device: str | torch.device = "cuda", cin: int = 1):
        super().__init__()
        self.config = config
        self.outer_enc = OuterEncoder(config, cin)
        code = self.outer_enc.out_features
        self.inner = InnerVAE(config, code)
        self.outer_dec = OuterDecoder(config, code)
        self.siamese = SiameseEncoder(config, cin)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, eps: torch.Tensor | None = None,
                train: bool = False, embed: bool = True) -> dict:
        """`eps` (B, inner_latent) N(0, 1) draws: used only in training.
        `embed` False leaves out the siamese branch (its output is
        "embedding"), which nothing downstream of a reconstruction
        reads."""
        code = self.outer_enc(x, train)
        z, mu, logvar, recon_code = self.inner(code, eps, train)
        recon = self.outer_dec(recon_code, train)
        if x.dim() == 3:
            recon = recon[..., 0]
        out = {"recon": recon, "z": z, "mu": mu, "logvar": logvar}
        if embed:
            out["embedding"] = self.siamese(x, train)
        return out

    def embed(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.siamese(x, train)


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))


def gradient_penalty(critic_fn, mix_eps: torch.Tensor, real: torch.Tensor,
                     fake: torch.Tensor, create_graph: bool = True
                     ) -> torch.Tensor:
    """WGAN-GP interpolation penalty (ga-vae gp weight 10). `mix_eps`
    (B,) uniforms mix each real image with its fake. The critic treats
    each image alone, so the per-sample gradients are the gradient of
    the sum; `create_graph` lets the penalty train the critic."""
    eps = mix_eps.reshape((-1,) + (1,) * (real.dim() - 1)).to(real.dtype)
    mix = eps * real + (1 - eps) * fake
    if not mix.requires_grad:
        mix = mix.detach().requires_grad_(True)
    g, = torch.autograd.grad(critic_fn(mix).sum(), mix,
                             create_graph=create_graph)
    norms = torch.sqrt(torch.sum(g ** 2, dim=tuple(range(1, g.dim())))
                       + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def polar_warp(img: torch.Tensor) -> torch.Tensor:
    """Cartesian -> polar resample about the image centre (the ga-vae
    rotation-invariance augmentation; reference misc_py/cart-to-polar.py),
    nearest pixel below (coordinates truncated), float32 coordinates as
    emx computes them."""
    n = img.shape[-1]
    r = torch.linspace(0, n / 2 - 1, n, dtype=torch.float32)
    theta = torch.arange(n, dtype=torch.float32) * (2 * math.pi / n)
    rr, tt = torch.meshgrid(r, theta, indexing="ij")
    ys = n / 2 + rr * torch.sin(tt)
    xs = n / 2 + rr * torch.cos(tt)
    y0 = torch.clamp(ys.to(torch.int32), 0, n - 1).long().to(img.device)
    x0 = torch.clamp(xs.to(torch.int32), 0, n - 1).long().to(img.device)
    return img[..., y0, x0]


def cutout_size(n: int, frac: float = 0.25) -> int:
    return max(1, int(frac * n))


def cutout(imgs: torch.Tensor, corners: torch.Tensor,
           frac: float = 0.25) -> torch.Tensor:
    """A square of side max(1, frac * n) at each image's (y, x) corner
    (`corners` (B, 2), each in [0, n - side]) filled with that image's
    mean; (B, n, n)."""
    n = imgs.shape[-1]
    s = cutout_size(n, frac)
    ar = torch.arange(n, device=imgs.device)
    y = corners[:, 0].to(imgs.device)[:, None, None]
    x = corners[:, 1].to(imgs.device)[:, None, None]
    rows, cols = ar[None, :, None], ar[None, None, :]
    mask = (rows >= y) & (rows < y + s) & (cols >= x) & (cols < x + s)
    mean = torch.mean(imgs, dim=(-2, -1), keepdim=True)
    return torch.where(mask, mean, imgs)


def vaegan_draws(generator: torch.Generator, b: int, n: int,
                 cfg: VAEGANConfig) -> dict[str, torch.Tensor]:
    """A generator step's draws on the generator's device: the inner
    VAE's eps (b, inner_latent) and the cutout corners (b, 2)."""
    dev = generator.device
    return {"eps": torch.randn((b, cfg.inner_latent), generator=generator,
                               device=dev),
            "cutout": torch.randint(0, n - cutout_size(n) + 1, (b, 2),
                                    generator=generator, device=dev)}


@dataclasses.dataclass
class VAEGANLossWeights:
    wass: float = 1.0
    gp: float = 10.0
    kl: float = 1.0
    rot_invar: float = 1.0
    siamese: float = 1.0
    mse: float = 1.0


def vaegan_losses(model: NestedVAEGAN, critic: SpectralCritic,
                  batch: torch.Tensor, draws: dict[str, torch.Tensor],
                  weights: VAEGANLossWeights = VAEGANLossWeights()):
    """All generator-side losses of the reference experiment()
    (ga-vae.py:852-1050), evaluated in one pass: (total, parts). The
    critic reads its stored u and does not update it. emx's parts also
    hold a gradient penalty of the reconstructions, which no term of
    `total` uses and nothing reads (XLA drops it); the port leaves it
    out, and its critic step computes the penalty it trains on."""
    out = model(batch, draws["eps"], train=True, embed=False)
    recon = out["recon"]
    mse = torch.mean((recon - batch) ** 2)
    kl = kl_divergence(out["mu"], out["logvar"])
    wass = -torch.mean(critic(recon))
    emb = model.embed(batch)
    rot_invar = torch.mean((emb - model.embed(
        torch.rot90(batch, 1, (-2, -1)))) ** 2)
    emb_cut = model.embed(cutout(batch, draws["cutout"]))
    siamese = torch.mean((emb - emb_cut) ** 2)
    total = (weights.mse * mse + weights.kl * kl + weights.wass * wass
             + weights.rot_invar * rot_invar + weights.siamese * siamese)
    parts = {"mse": mse, "kl": kl, "wass": wass, "rot_invar": rot_invar,
             "siamese": siamese}
    return total, parts

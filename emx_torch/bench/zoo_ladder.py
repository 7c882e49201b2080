"""Model-zoo quality ladder (port of emx/bench/zoo_ladder.py): short
trained-quality runs with a task metric for one representative of each
model family beyond the denoiser and the GAN.

Families and metrics (each scored against an anchor):
  * small_ae     SmallAutoencoder: val reconstruction PSNR against the
                 best constant (per-image mean) predictor.
  * xception_ae  XceptionAutoencoder (bf16): the same.
  * latent_ae    LatentAutoencoder (128x128): the same.
  * embedder     UnsupervisedEmbedder (bf16): top-1 nearest-neighbour
                 retrieval of the augmented-pair partner against chance.
  * embedder_nce the same encoder and task under a symmetric InfoNCE.
  * kernels      KernelBank: best-kernel denoise PSNR against the
                 Gaussian filter.
  * vaegan       NestedVAEGAN + SpectralCritic (WGAN-GP alternation):
                 reconstruction PSNR and cutout retrieval; three variants
                 (kl 0.1, the critic annealed in, the critic at 0.1).
  * manifold     SharedManifoldTranslator: A->B translation PSNR against
                 the identity.

emx's data seeds, batch sizes, learning rates, scale rules, metrics and
rounding. The data are numpy (synthetic_micrographs), so every anchor
computed from data alone equals emx's. The random draws are the port's
own: batch indices, crops, dropout, Poisson noise, the VAE's eps and the
critic's mixing weights come from a torch.Generator on the batch's
device, and the parameters start from the port's initialisation (flax's
distributions, not its numbers): a family's trained result is held to
emx's record within a tolerance, not exactly.

Each family's step is a function of its draws (`recon_step`,
`embedder_step`, `kernels_degrade` + the bank's step, `vaegan_step`,
`manifold_step`), so the tests feed them emx's. The results add to
emx's keys the first loss of the run, and on the card the rate of the
steps after the first (`steps_per_s`, `step_ms`) and their peak memory
(`peak_gib`); no rate is recorded from a CPU, nor with `--no-rates`.

Usage: python -m emx_torch.bench.zoo_ladder [out_dir] [steps] [scale]
[size] [--families=a,b] [--device=cpu] [--no-rates] [--deterministic]
[--seed=N]. Writes
<out_dir>/quality.json
(resumable family by family); prints one JSON line per family and the
summary. `python -m emx_torch.bench.zoo_ladder --compare` prints the
committed docs/runs/port_zoo_ladder*/ results against emx's records,
one JSON row per headline metric, with RECORD_TOLERANCES.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from emx_torch.analysis.filters import _per_image_psnr
from emx_torch.data.pipeline import synthetic_micrographs
from emx_torch.nn.init import init_parameters
from emx_torch.utils.device import cudnn_deterministic, resolve_device
from emx_torch.utils.image import flip_rotate, scale0to1

METRIC = "zoo_ladder"


@functools.lru_cache(maxsize=16)
def _micrographs(n: int, size: int, seed: int) -> np.ndarray:
    """synthetic_micrographs, made once per (n, size, seed) in a process:
    the families share data sets (the four VAE-GANs, the two embedders)."""
    out = synthetic_micrographs(n, size, seed=seed)
    out.flags.writeable = False
    return out


def _data(n: int, size: int, seed: int, device) -> torch.Tensor:
    return torch.tensor(_micrographs(n, size, seed), device=device)


def _psnr_mean(pred: torch.Tensor, truth: torch.Tensor) -> float:
    """emx's jnp.mean(jax.vmap(psnr)(pred, truth))."""
    return float(torch.mean(_per_image_psnr(pred, truth)))


def _const_anchor(val: torch.Tensor) -> float:
    """PSNR of the best constant (per-image mean) predictor."""
    mean = torch.mean(val, dim=(-2, -1), keepdim=True)
    return _psnr_mean(mean.expand_as(val), val)


def _init(model: torch.nn.Module, seed: int, device) -> torch.nn.Module:
    """The port's initialisation from `seed` (made on the CPU), then moved
    to `device`."""
    return init_parameters(model, torch.Generator().manual_seed(seed)).to(
        device)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _timed(device: torch.device) -> bool:
    return device.type == "cuda"


def _train_loop(device: torch.device, steps: int, step) -> tuple[list,
                                                                  dict]:
    """[step(i) for i in range(steps)], and on the card the wall time of
    steps 1..steps-1 (the first compiles nothing here, but pays cuDNN's
    algorithm choice and allocations), synchronised before the second
    step and after the last, so that no evaluation after the loop is
    counted: `steps_per_s`, `step_ms` and the peak memory of those steps
    (`peak_gib`). On the CPU, or for one step, no rate: {}."""
    timed = _timed(device) and steps > 1
    outs, t0 = [], None
    for i in range(steps):
        if timed and i == 1:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
        outs.append(step(i))
    if not timed:
        return outs, {}
    torch.cuda.synchronize(device)
    dt, n = time.perf_counter() - t0, steps - 1
    return outs, {"steps_per_s": round(n / dt, 2),
                  "step_ms": round(1e3 * dt / n, 3),
                  "peak_gib": round(torch.cuda.max_memory_allocated(device)
                                    / 2 ** 30, 3)}


# --------------------------------------------------------------------------
# Reconstruction families
# --------------------------------------------------------------------------
def recon_step(model, opt, imgs: torch.Tensor, **model_kw) -> torch.Tensor:
    """One Adam step of model(x) -> x under MSE (BatchNorm statistics
    move as in training); returns the loss (a device tensor)."""
    loss = torch.mean((model(imgs, train=True, **model_kw) - imgs) ** 2)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def _train_recon(model, train_imgs, val_imgs, steps: int, batch: int,
                 lr: float = 1e-3, seed: int = 0, dropout: bool = False
                 ) -> dict:
    dev = train_imgs.device
    model = _init(model, seed, dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    gen, n = _generator(dev, seed + 1), train_imgs.shape[0]
    kw = {"generator": gen} if dropout else {}

    def step(i):
        idx = torch.randint(0, n, (batch,), generator=gen, device=dev)
        return recon_step(model, opt, train_imgs[idx], **kw)

    losses, rates = _train_loop(dev, steps, step)
    with torch.no_grad():
        out = model(val_imgs, train=False)
    return {"psnr": _psnr_mean(out, val_imgs), "losses": losses, **rates}


def _recon_result(r: dict, val: torch.Tensor) -> dict:
    return {"psnr": round(r["psnr"], 2),
            "anchor_const_psnr": round(_const_anchor(val), 2),
            "final_loss": round(float(r["losses"][-1]), 5),
            "first_loss": round(float(r["losses"][0]), 5),
            **{k: r[k] for k in RATE_KEYS if k in r}}


def _s(v: int, scale: float, lo: int = 8) -> int:
    return max(lo, int(v * scale))


def small_ae_config(scale: float):
    from emx_torch.nn.autoencoder import SmallAEConfig

    return SmallAEConfig() if scale >= 1 else SmallAEConfig(
        features=(16, 24, 32), bottleneck=16)


def xception_ae_config(scale: float):
    from emx_torch.nn.autoencoder import XceptionAEConfig

    return XceptionAEConfig(
        entry_features=tuple(_s(f, scale) for f in (128, 256, 728)),
        num_middle_blocks=max(1, int(16 * scale)),
        exit_features=tuple(_s(f, scale) for f in (728, 1024)),
        aspp_out=_s(256, scale),
        decoder_features=tuple(_s(f, scale) for f in (256, 128, 64, 32)),
        dtype=torch.bfloat16)


LATENT_SIZE = 128   # the decoder emits 4 * 2^k: a power-of-two size


def latent_ae_config(scale: float, size: int = LATENT_SIZE):
    from emx_torch.nn.latent import LatentAEConfig

    n_dec = int(np.log2(size // 4))
    full = LatentAEConfig()
    return dataclasses.replace(
        full,
        enc_features=tuple(_s(f, scale) for f in full.enc_features[:n_dec]),
        head_features=tuple(_s(f, scale) for f in full.head_features),
        dec_features=tuple(_s(f, scale) for f in full.dec_features[-n_dec:]),
        latent_dim=_s(full.latent_dim, scale, 16))


def run_small_ae(steps, scale, size, seed=0, device="cuda"):
    from emx_torch.nn.autoencoder import SmallAutoencoder

    dev = resolve_device(device)
    model = SmallAutoencoder(small_ae_config(scale), device="cpu")
    train, val = _data(256, size, 1, dev), _data(16, size, 99, dev)
    return _recon_result(_train_recon(model, train, val, steps, 16,
                                      seed=seed), val)


def run_xception_ae(steps, scale, size, seed=0, device="cuda"):
    from emx_torch.nn.autoencoder import XceptionAutoencoder

    dev = resolve_device(device)
    model = XceptionAutoencoder(xception_ae_config(scale), device="cpu")
    train, val = _data(256, size, 2, dev), _data(16, size, 98, dev)
    return _recon_result(_train_recon(model, train, val, steps, 8,
                                      seed=seed), val)


def run_latent_ae(steps, scale, size, seed=0, device="cuda"):
    from emx_torch.nn.latent import LatentAutoencoder

    dev = resolve_device(device)
    model = LatentAutoencoder(latent_ae_config(scale), device="cpu")
    train = _data(256, LATENT_SIZE, 3, dev)
    val = _data(16, LATENT_SIZE, 97, dev)
    return _recon_result(_train_recon(model, train, val, steps, 8,
                                      seed=seed, dropout=True), val)


# --------------------------------------------------------------------------
# Retrieval families
# --------------------------------------------------------------------------
def embedder_config(scale: float):
    from emx_torch.nn.autoencoder import EmbedderConfig

    return EmbedderConfig(
        entry_features=tuple(_s(f, scale) for f in (128, 256, 728)),
        num_middle_blocks=max(1, int(8 * scale)),
        fc_features=_s(4096, scale, 32), embedding_dim=30,
        dtype=torch.bfloat16)


def crop_draws(generator: torch.Generator, b: int, hi: int
               ) -> dict[str, torch.Tensor]:
    """Two crops of each of b images: corners (b, 2) in [0, hi) per axis
    and rot90 counts (b, 2) in [0, 4)."""
    dev = generator.device
    return {k: torch.randint(0, top, (b, 2), generator=generator,
                             device=dev)
            for k, top in (("oy", hi), ("ox", hi), ("rot", 4))}


def make_pairs(imgs: torch.Tensor, draws: dict[str, torch.Tensor],
               crop: int) -> torch.Tensor:
    """(2b, crop, crop): rows 2i and 2i+1 are two crops of image i, each
    rotated by its rot90 count (emx's flip_rotate choices 0-3)."""
    b = imgs.shape[0]
    ar = torch.arange(crop, device=imgs.device)
    rows = draws["oy"].reshape(-1)[:, None] + ar       # (2b, crop)
    cols = draws["ox"].reshape(-1)[:, None] + ar
    src = torch.arange(b, device=imgs.device).repeat_interleave(2)
    crops = imgs[src[:, None, None], rows[:, :, None], cols[:, None, :]]
    return flip_rotate(crops, draws["rot"].reshape(-1))


def info_nce(e: torch.Tensor, temp: float = 0.1) -> torch.Tensor:
    """Symmetric InfoNCE (NT-Xent) over in-batch negatives; (2i, 2i+1)
    are the positive pairs."""
    e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                        min=1e-8)
    n = e.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=e.device)
    logits = ((e @ e.T) / temp).masked_fill(eye, -1e9)
    partner = torch.arange(n, device=e.device) ^ 1
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-logp[torch.arange(n, device=e.device), partner])


def embedder_step(model, opt, imgs: torch.Tensor,
                  draws: dict[str, torch.Tensor], crop: int,
                  loss_fn) -> torch.Tensor:
    """One Adam step of the pair metric `loss_fn` on the penultimate
    features of the two crops of each image."""
    e = model(make_pairs(imgs, draws, crop), train=True, features=True)
    loss = loss_fn(e.float())
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def _run_embedder(steps, scale, size, seed, device, loss_fn, batch):
    from emx_torch.nn.autoencoder import UnsupervisedEmbedder

    dev = resolve_device(device)
    # Pairs are two random crops of one parent micrograph (+ a rotation):
    # 512 parents, so the metric cannot memorise the pool.
    crop = size * 2 // 3
    hi = size - crop
    imgs = _data(512, size, 4, dev)
    model = _init(UnsupervisedEmbedder(embedder_config(scale), device="cpu"),
                  seed, dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    gen = _generator(dev, seed + 1)

    def step(i):
        idx = torch.randint(0, imgs.shape[0], (batch,), generator=gen,
                            device=dev)
        return embedder_step(model, opt, imgs[idx],
                             crop_draws(gen, batch, hi), crop, loss_fn)

    losses, rates = _train_loop(dev, steps, step)
    # Held-out retrieval: nearest neighbour over the penultimate features,
    # the partner being the other crop of the same parent.
    val = _data(32, size, 96, dev)
    pairs = make_pairs(val, crop_draws(_generator(dev, 7), 32, hi), crop)
    with torch.no_grad():
        e = model(pairs, train=False, features=True)
    e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                        min=1e-8)
    sim = (e @ e.T).cpu().numpy()
    np.fill_diagonal(sim, -np.inf)
    nn_idx = sim.argmax(axis=1)
    partner = np.arange(len(nn_idx)) ^ 1
    return {"top1_retrieval": round(float((nn_idx == partner).mean()), 3),
            "chance": round(1.0 / (len(nn_idx) - 1), 4), "crop": crop,
            "final_loss": round(float(losses[-1]), 5),
            "first_loss": round(float(losses[0]), 5), **rates}


def run_embedder(steps, scale, size, seed=0, device="cuda"):
    """The reference's paired-cosine / median-margin metric loss on the
    penultimate features (unsupervised_Xception.py:700-712)."""
    from emx_torch.nn.autoencoder import embedder_metric_loss

    return _run_embedder(steps, scale, size, seed, device,
                         embedder_metric_loss, 16)


def run_embedder_nce(steps, scale, size, seed=0, device="cuda"):
    """The same encoder and pairs under a symmetric InfoNCE: every off-pair
    in the batch is a negative with its own gradient."""
    return _run_embedder(steps, scale, size, seed, device, info_nce, 32)


# --------------------------------------------------------------------------
# Kernel bank
# --------------------------------------------------------------------------
def kernels_degrade(generator: torch.Generator, imgs: torch.Tensor):
    """(noisy, target): Poisson(img * dose) per image, dose 25 + 75 *
    Exponential(1), rescaled to [0, 1]; the target is the clean image at
    the noisy image's mean. torch.poisson, as emx's jax.random.poisson
    (this path never runs the fused degrade kernel)."""
    b = imgs.shape[0]
    doses = 25.0 + torch.empty(b, device=imgs.device).exponential_(
        1.0, generator=generator) * 75.0
    counts = torch.poisson(imgs * doses[:, None, None], generator=generator)
    lq = scale0to1(counts, dim=(-2, -1))
    tgt = imgs * (torch.mean(lq, dim=(-2, -1), keepdim=True)
                  / torch.clamp(torch.mean(imgs, dim=(-2, -1),
                                           keepdim=True), min=1e-12))
    return lq, tgt


def run_kernels(steps, scale, size, seed=0, device="cuda"):
    from emx_torch.analysis.filters import gaussian_filter
    from emx_torch.nn.kernels import KernelBank

    dev = resolve_device(device)
    bank = KernelBank(depths=(1, 2, 3), widths=(3, 5, 7), device=dev)
    train, val = _data(64, size, 5, dev), _data(16, size, 95, dev)
    state, step = bank.init(), bank.make_step()
    gen = _generator(dev, seed + 1)

    def bank_step(i):
        nonlocal state
        idx = torch.randint(0, train.shape[0], (8,), generator=gen,
                            device=dev)
        noisy, clean = kernels_degrade(gen, train[idx])
        state, ls = step(state, noisy, clean)
        return ls

    losses, rates = _train_loop(dev, steps, bank_step)
    noisy, clean = kernels_degrade(_generator(dev, 9), val)
    scores = {}
    with torch.no_grad():
        for label, m in zip(bank.labels(), state["models"]):
            scores[label] = round(_psnr_mean(m(noisy), clean), 2)
        anchor = round(_psnr_mean(gaussian_filter(noisy, 1.5), clean), 2)
    best = max(scores.items(), key=lambda kv: kv[1])
    return {"best_kernel": best[0], "best_psnr": best[1],
            "anchor_gaussian_psnr": anchor, "all": scores,
            "final_loss": round(float(torch.mean(losses[-1])), 5),
            "first_loss": round(float(torch.mean(losses[0])), 5), **rates}


# --------------------------------------------------------------------------
# VAE-GAN
# --------------------------------------------------------------------------
def vaegan_config(scale: float):
    from emx_torch.nn.vaegan import VAEGANConfig

    return VAEGANConfig().scaled(scale)


def vaegan_step_draws(generator: torch.Generator, b: int, n: int, cfg
                      ) -> dict[str, torch.Tensor]:
    """The critic's mixing weights (`c_gp`) and the generator side's
    draws (emx_torch.nn.vaegan.vaegan_draws)."""
    from emx_torch.nn.vaegan import vaegan_draws

    c_gp = torch.rand((b,), generator=generator, device=generator.device)
    return {"c_gp": c_gp, **vaegan_draws(generator, b, n, cfg)}


def vaegan_step(model, critic, g_opt, c_opt, imgs: torch.Tensor,
                draws: dict[str, torch.Tensor], wass: float = 1.0,
                kl: float = 1.0) -> dict[str, torch.Tensor]:
    """One WGAN-GP alternation (emx's fused step): the critic maximises
    critic(real) - critic(fake) - 10 GP, refreshing its spectral u on the
    real then the fake batch; then the generator side minimises
    vaegan_losses against the stepped critic (its u read, not moved)."""
    from emx_torch.nn.vaegan import (VAEGANLossWeights, gradient_penalty,
                                     vaegan_losses)

    with torch.no_grad():
        fake = model(imgs, None, train=False, embed=False)["recon"]
    real_s = critic(imgs, update=True)
    fake_s = critic(fake, update=True)
    gp = gradient_penalty(critic, draws["c_gp"], imgs, fake)
    c_loss = torch.mean(fake_s) - torch.mean(real_s) + 10.0 * gp
    c_opt.zero_grad(set_to_none=True)
    c_loss.backward()
    c_opt.step()

    total, parts = vaegan_losses(model, critic, imgs, draws,
                                 VAEGANLossWeights(kl=kl, wass=wass))
    params = list(model.parameters())
    grads = torch.autograd.grad(total, params)
    for p, g in zip(params, grads):
        p.grad = g
    g_opt.step()
    g_opt.zero_grad(set_to_none=True)
    return {"critic_loss": c_loss.detach(), "total": total.detach(),
            "mse": parts["mse"].detach()}


def run_vaegan(steps, scale, size, seed=0, kl_weight=1.0, wass_weight=1.0,
               wass_anneal=False, device="cuda"):
    """Nested VAE-GAN (reference misc_py/ga-vae.py:852-1050): val
    reconstruction PSNR through the nested bottleneck against the best
    constant, and top-1 retrieval of a cutout view's clean partner
    against chance. `kl_weight` relaxes the inner VAE's bottleneck;
    `wass_anneal` ramps the critic's weight 0 -> wass_weight over the
    first half of training."""
    from emx_torch.nn.vaegan import NestedVAEGAN, SpectralCritic, cutout

    dev = resolve_device(device)
    cfg = vaegan_config(scale)
    train, val = _data(256, size, 3, dev), _data(16, size, 97, dev)
    batch = 8
    model = _init(NestedVAEGAN(cfg, device="cpu"), seed, dev)
    critic = _init(SpectralCritic(cfg, device="cpu"), seed + 1, dev)
    g_opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.5, 0.999))
    c_opt = torch.optim.Adam(critic.parameters(), lr=1e-4,
                             betas=(0.5, 0.999))
    gen = _generator(dev, seed + 2)

    def step(i):
        idx = torch.randint(0, train.shape[0], (batch,), generator=gen,
                            device=dev)
        w = (wass_weight * min(1.0, i / max(steps * 0.5, 1))
             if wass_anneal else wass_weight)
        return vaegan_step(model, critic, g_opt, c_opt, train[idx],
                           vaegan_step_draws(gen, batch, size, cfg), w,
                           kl_weight)["mse"]

    mses, rates = _train_loop(dev, steps, step)
    from emx_torch.nn.vaegan import cutout_size

    corners = torch.randint(0, size - cutout_size(size) + 1, (len(val), 2),
                            generator=_generator(dev, 7), device=dev)
    with torch.no_grad():
        recon = model(val, None, train=False, embed=False)["recon"]
        emb = model.embed(val)
        emb_cut = model.embed(cutout(val, corners))
    d = torch.sum((emb_cut[:, None] - emb[None]) ** 2, dim=-1)
    top1 = float(torch.mean((torch.argmin(d, dim=1) == torch.arange(
        len(val), device=dev)).float()))
    return {"psnr": round(_psnr_mean(recon, val), 2),
            "anchor_const_psnr": round(_const_anchor(val), 2),
            "cutout_top1_retrieval": round(top1, 3),
            "chance": round(1.0 / len(val), 3),
            "final_mse": round(float(mses[-1]), 5),
            "first_mse": round(float(mses[0]), 5), **rates}


# --------------------------------------------------------------------------
# Shared-manifold translator
# --------------------------------------------------------------------------
def manifold_config(scale: float):
    from emx_torch.nn.manifold import ManifoldConfig

    return ManifoldConfig().scaled(scale)


def to_domain_b(a: torch.Tensor) -> torch.Tensor:
    """The simulated second modality: contrast-inverted and blurred."""
    from emx_torch.analysis.filters import gaussian_filter

    return 1.0 - gaussian_filter(a, 1.5)


def manifold_step(model, m_opt, c_opt, a: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """The distillers and generators take recon + confusion; then the
    confuser takes its BCE on the codes of the updated distillers.
    Returns the recon loss."""
    from emx_torch.nn.manifold import confuser_bce, manifold_losses

    main = [p for n, p in model.named_parameters()
            if not n.startswith("confuser.")]
    losses = manifold_losses(model(a, b, train=True), a, b)
    grads = torch.autograd.grad(losses["recon"] + losses["confusion"], main)
    for p, g in zip(main, grads):
        p.grad = g
    m_opt.step()
    m_opt.zero_grad(set_to_none=True)
    with torch.no_grad():
        code_a, code_b = model.distill_a(a, True), model.distill_b(b, True)
    c_loss = confuser_bce(model.confuser(code_a), model.confuser(code_b))
    c_opt.zero_grad(set_to_none=True)
    c_loss.backward()
    c_opt.step()
    return losses["recon"].detach()


def run_manifold(steps, scale, size, seed=0, device="cuda"):
    """Shared-manifold translator (reference misc_py/shared_manifold.pyw:
    945-1035): domain A a micrograph, domain B contrast-inverted and
    blurred, unpaired batches. Metric: A->B translation PSNR on held-out
    pairs against the identity (A fed unchanged)."""
    from emx_torch.nn.manifold import SharedManifoldTranslator

    dev = resolve_device(device)
    train, val = _data(256, size, 4, dev), _data(16, size, 96, dev)
    train_b, val_b = to_domain_b(train), to_domain_b(val)
    batch = 8
    model = _init(SharedManifoldTranslator(manifold_config(scale),
                                           device="cpu"), seed, dev)
    main = [p for n, p in model.named_parameters()
            if not n.startswith("confuser.")]
    m_opt = torch.optim.Adam(main, lr=2e-4)
    c_opt = torch.optim.Adam(model.confuser.parameters(), lr=2e-4)
    gen, n = _generator(dev, seed + 2), train.shape[0]

    def step(i):
        ia = torch.randint(0, n, (batch,), generator=gen, device=dev)
        ib = torch.randint(0, n, (batch,), generator=gen, device=dev)
        return manifold_step(model, m_opt, c_opt, train[ia], train_b[ib])

    losses, rates = _train_loop(dev, steps, step)
    with torch.no_grad():
        out = model(val, val_b, train=False)
    return {"a_to_b_psnr": round(_psnr_mean(out["a_to_b"], val_b), 2),
            "anchor_identity_psnr": round(_psnr_mean(val, val_b), 2),
            "recon_a_psnr": round(_psnr_mean(out["recon_a"], val), 2),
            "anchor_const_psnr": round(_const_anchor(val), 2),
            "final_recon_loss": round(float(losses[-1]), 5),
            "first_recon_loss": round(float(losses[0]), 5), **rates}


FAMILIES = {
    "small_ae": run_small_ae,
    "xception_ae": run_xception_ae,
    "latent_ae": run_latent_ae,
    "embedder": run_embedder,
    "kernels": run_kernels,
    "vaegan": run_vaegan,
    "manifold": run_manifold,
    "embedder_nce": run_embedder_nce,
    "vaegan_kl01": lambda steps, scale, size, **kw: run_vaegan(
        steps, scale, size, kl_weight=0.1, **kw),
    "vaegan_anneal": lambda steps, scale, size, **kw: run_vaegan(
        steps, scale, size, wass_anneal=True, **kw),
    "vaegan_wass01": lambda steps, scale, size, **kw: run_vaegan(
        steps, scale, size, wass_weight=0.1, **kw),
}
RECON_FAMILIES = ("small_ae", "xception_ae", "latent_ae")


# The port's ladder files beside emx's records of the same budgets.
RECORD_PAIRS = tuple((f"docs/runs/port_zoo_ladder{x}/quality.json",
                      f"docs/runs/zoo_ladder{x}/quality.json")
                     for x in ("", "_ext", "_ext2", "_ext3"))
# The tolerance each headline metric is held to against emx's record
# (trained outcomes under other draws), fixed before the first uncut card
# run (PERF.md §6): family -> [(metric, tolerance, anchor)]; with an
# anchor, the port must also sit on the record's side of it.
RECORD_TOLERANCES = {
    **{f: [("psnr", 1.0, None)] for f in RECON_FAMILIES},
    "kernels": [("best_psnr", 0.5, None)],
    "embedder": [("top1_retrieval", 0.04, None)],
    "embedder_nce": [("top1_retrieval", 0.08, None)],
    **{f: [("psnr", 2.5, "anchor_const_psnr")]
       for f in ("vaegan", "vaegan_kl01", "vaegan_anneal", "vaegan_wass01")},
    "manifold": [("a_to_b_psnr", 2.5, "anchor_identity_psnr"),
                 ("recon_a_psnr", 2.5, "anchor_const_psnr")],
}


def compare_to_record(port: dict, record: dict) -> list[dict]:
    """One row per headline metric of each family in both results: the
    port's value, the record's, the difference, the tolerance, and
    whether it holds (within the tolerance, on the record's side of the
    anchor; for kernels also the best kernel among the record's top
    three)."""
    rows = []
    for name, checks in RECORD_TOLERANCES.items():
        if name not in port or name not in record:
            continue
        got, rec = port[name], record[name]
        for metric, tol, anchor in checks:
            diff = got[metric] - rec[metric]
            ok = abs(diff) <= tol + 1e-9
            note = ""
            if anchor:
                side = ((got[metric] > got[anchor])
                        == (rec[metric] > rec[anchor]))
                ok &= side
                note = (f"{'same' if side else 'other'} side of "
                        f"{anchor} {got[anchor]}")
            if name == "kernels":
                top3 = sorted(rec["all"], key=rec["all"].get)[-3:]
                among = got["best_kernel"] in top3
                ok &= among
                note = (f"best {got['best_kernel']} "
                        f"{'among' if among else 'not among'} the record's "
                        f"top three {sorted(top3)}")
            rows.append({"family": name, "metric": metric,
                         "port": got[metric], "record": rec[metric],
                         "diff": round(diff, 4), "tol": tol, "ok": bool(ok),
                         "note": note})
    return rows


def compare_records(pairs=RECORD_PAIRS) -> list[dict]:
    """compare_to_record over the port's files and emx's, with each
    row's steps."""
    rows = []
    for port_path, emx_path in pairs:
        with open(port_path) as f:
            port = json.load(f)
        with open(emx_path) as f:
            record = json.load(f)
        for row in compare_to_record(port["families"], record["families"]):
            rows.append({"steps": record["steps"], **row})
    return rows


RATE_KEYS = ("steps_per_s", "step_ms", "peak_gib")


def main(out_dir: str = "docs/runs/port_zoo_ladder", steps: int = 1500,
         scale: float = 0.25, size: int = 96,
         families: list[str] | None = None,
         device: str | torch.device = "cuda", rates: bool = True,
         deterministic: bool = False, seed: int = 0) -> dict:
    """`rates=False` leaves the card's rates out of the results (a run
    that shares the card); `deterministic` runs cuDNN's deterministic
    algorithms, so that a family's result repeats on one card; `seed`
    moves every family's initialisation and draws (emx's records are
    seed 0)."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "quality.json")
    results: dict = {}
    if os.path.exists(path):  # resume family by family
        with open(path) as f:
            results = json.load(f).get("families", results)
    head = {"metric": METRIC, "steps": steps, "scale": scale, "size": size,
            "seed": seed, "deterministic": deterministic,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}
    for name in families or FAMILIES:
        if name in results and "error" not in results[name]:
            continue  # resume: keep completed families, retry errored
        t0 = time.perf_counter()
        try:
            with (cudnn_deterministic() if deterministic
                  else contextlib.nullcontext()):
                r = FAMILIES[name](steps, scale, size, seed=seed, device=dev)
        except Exception as e:  # noqa: BLE001 - recorded, as emx's
            r = {"error": f"{type(e).__name__}: {e}"[:300]}
        if not rates:
            r = {k: v for k, v in r.items() if k not in RATE_KEYS}
        r["seconds"] = round(time.perf_counter() - t0, 1)
        results[name] = r
        print(json.dumps({"family": name, **r}), flush=True)
        with open(path, "w") as f:
            json.dump({**head, "families": results}, f, indent=1)
    summary = {**head, "families": results}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    if "--compare" in sys.argv[1:]:
        for row in compare_records():
            print(json.dumps(row), flush=True)
        raise SystemExit(0)
    flags = {a.split("=", 1)[0]: a.split("=", 1)[1]
             for a in sys.argv[1:] if a.startswith("--") and "=" in a}
    a = [x for x in sys.argv[1:] if not x.startswith("-")]
    main(a[0] if a else "docs/runs/port_zoo_ladder",
         int(a[1]) if len(a) > 1 else 1500,
         float(a[2]) if len(a) > 2 else 0.25,
         int(a[3]) if len(a) > 3 else 96,
         families=(flags["--families"].split(",")
                   if "--families" in flags else None),
         device=flags.get("--device", "cuda"),
         rates="--no-rates" not in sys.argv[1:],
         deterministic="--deterministic" in sys.argv[1:],
         seed=int(flags.get("--seed", 0)))

#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

    python3 chip_smoke.py        # from the repository root; one card, nvcc

Phases, one line each (a phase that fails raises; the script then exits
non-zero and prints no result):

  1. device  the card's name, the device count, and nvidia-smi's name
             and power limit. No CUDA device: raise.
  2. build   nvcc builds emx_torch/csrc/{sepconv,degrade}.cu, one process
             each, started together; seconds and the ptxas register /
             shared-memory lines.
  3. kernel  K1 (fused_sepconv) against its plain PyTorch version on the
             card, at the six flagship shapes at B=8 (one batch-8
             forward's fused blocks) and at B=1 (the server's latency
             regime), 128x128, bf16, and two ragged ones; the kernel's
             schedule (channels per pass, band, grid, shared memory);
             CUDA-event times of the kernel, the plain version and the
             cuDNN depthwise + pointwise pair, the card's least time for
             the same work and the share of it the kernel reaches.
  4. degrade K2 (fused_poisson_degrade) against its plain version,
             identical on every element, at (16, 512, 512) with training
             doses and on constant images at rates 0.5 to 200, one launch
             per call; its schedule; times of the kernel, the plain
             version and torch.poisson + min/max + rescale, and the
             card's least time for this data.
  5. serve   emx_torch.serve.server.serve_artifact on the flagship int8
             bundle with fused_rows=32: 512x512 requests and one
             1024x768 (tiled) request over HTTP. Checks shape, finite
             [0, 1] outputs, six K1 launches per 512x512 forward,
             denoised PSNR above noisy PSNR, and the fused graph against
             the unfused int8 graph; times the forward at batch 1 and 8.
  6. train   Trainer.fit on the flagship's training config at full width
             (BatchNorm, bf16, s2d 4, folded head 128, remat middle, 11
             middle blocks, nesterov 1e-3, batch 16 at 512x512) from the
             port's own initialisation, on DeviceDataset(synthetic_
             micrographs(64, 512)), with a checkpoint halfway. Checks a
             finite loss every step, the loss falling, one K2 launch per
             step and an exact restore of the halfway checkpoint; step
             ms, img/s and peak memory.
  7. deploy  fold BatchNorm, the folded model against the BatchNorm model,
             calibrate int8 mxu, save a bundle (into a temporary
             directory), serve it with fused_rows=32 and answer a 512x512
             request: shape, finite [0, 1], six K1 launches; the PSNR
             gain is reported.
  8. the kernels line (JSON), then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Inputs are made from fixed seeds with numpy; the weights of the trained
model from a seed. The phases are functions of (device, config), so the
CPU tests rehearse the ones that need no kernel on tiny configs.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import statistics
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from emx_torch.bench.kernel_times import (FLAGSHIP_BLOCKS, device_ms,
                                          host_paced_ms, sepconv_inputs)
from emx_torch.bench.train_profile import FLAGSHIP_TRAIN
from emx_torch.data import (DeviceDataset, PipelineConfig, denoiser_example,
                            synthetic_micrographs)
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.ops import _build, degrade_kernel, sepconv_kernel
from emx_torch.ops.degrade_kernel import (fused_poisson_degrade,
                                          poisson_counts_reference,
                                          poisson_degrade_reference)
from emx_torch.ops.sepconv_kernel import fused_sepconv, sepconv_reference
from emx_torch.serve.artifact import (load_denoiser_artifact,
                                      save_denoiser_artifact)
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.serve.fused import fused_quantized_apply, row_band
from emx_torch.serve.optimize import fold_denoiser
from emx_torch.serve.quantize import calibrate, quantized_apply
from emx_torch.serve.server import serve_artifact
from emx_torch.serve.tiling import _origins
from emx_torch.train import Checkpointer, TrainConfig, Trainer
from emx_torch.utils.device import card_name_and_power
from emx_torch.utils.image import psnr, scale0to1
from emx_torch.utils.metrics import read_jsonl

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12


@dataclasses.dataclass(frozen=True)
class SmokeConfig:
    bundle: str = "docs/runs/flagship/artifact_int8.npz"
    tile: int = 512
    overlap: int = 80
    fused_rows: int = 32
    n_requests: int = 4
    big_shape: tuple[int, int] = (1024, 768)
    # K1 launches per forward of the served graph (0 where no kernel runs).
    launches_per_forward: int = 6
    # Denoised PSNR must beat noisy PSNR by this much; None only reports
    # (random weights in the CPU rehearsal).
    min_psnr_gain_db: float | None = 0.0


DOSE = 50.0                    # Poisson dose of the smoke requests
MIN_FUSED_VS_INT8_PSNR_DB = 35.0  # fused graph against the unfused int8 one
TIMING_BATCHES = (1, 8)


# (name, B, H, W, C, Co): the six fused SepConvBlocks of one flagship
# forward at a 512x512 tile (emx/nn/denoiser.py:235-236, 281-282, 294-295).
FLAGSHIP_SHAPES = tuple((name, 8, *rest) for name, *rest in FLAGSHIP_BLOCKS)
# The same blocks at batch 1, the server's latency regime.
FLAGSHIP_SHAPES_B1 = tuple((f"{name}@b1", 1, *rest)
                           for name, _, *rest in FLAGSHIP_SHAPES)
RAGGED_SHAPES = (("ragged728", 1, 32, 32, 728, 728),
                 ("ragged20", 1, 130, 66, 20, 24))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def phase_device(device: torch.device) -> dict:
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    kind = torch.cuda.get_device_name(device)
    count = torch.cuda.device_count()
    smi = card_name_and_power()
    # The plain versions' float32 products run in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{kind}; device_count={count}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    print(smi, flush=True)
    return {"kind": kind, "count": count, "smi": smi}


KERNEL_SOURCES = ("sepconv", "degrade")


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = _build.load_all(KERNEL_SOURCES)
    out = {"seconds": time.perf_counter() - t0}
    for name, lib in built.items():
        ptxas = [ln.strip() for ln in lib.log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln]
        log("build", f"{name}.cu: nvcc done after {lib.seconds:.2f} s -> "
            f"{lib.path.name}")
        for ln in ptxas:
            log("build", ln)
        out[name] = {"seconds": lib.seconds, "ptxas": ptxas}
    log("build", f"all sources built and loaded in {out['seconds']:.2f} s")
    return out


def both_times(prefix: str, fn, iters: int = 20) -> dict:
    """`fn`'s ms per call two ways: `<prefix>ms` host-paced (CUDA events
    around calls issued back to back, the kernels line's `ms` since it
    began) and `<prefix>device_ms` with the calls queued ahead of the
    card, so the card's own time even where the host's share of a call
    is the larger."""
    return {f"{prefix}ms": host_paced_ms(fn, iters=iters),
            f"{prefix}device_ms": device_ms(fn, iters=iters)}


TIMED_KEYS = ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
              "library_device_ms", "bound_ms")


def flagship_sums(results: list[dict], batch: int) -> dict:
    """Each time summed over the six flagship blocks at `batch`."""
    timed = [r for r in results if "ms" in r and r["shape"][0] == batch]
    return {k: sum(r[k] for r in timed) for k in TIMED_KEYS}


def sepconv_bound_ms(b, h, w, c, co) -> tuple[float, str]:
    """Least time for the card: each input read once, the output written
    once; depthwise operations at the f32 rate, pointwise at bf16."""
    px = b * h * w
    nbytes = px * c * 2 + px * co * 2 + 4 * (9 * c + c + c * co + co)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = px * 18 * c / F32_OPS_PER_S + px * 2 * c * co / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _sepconv_schedule(device: torch.device, b, h, w, c, co) -> str:
    """The kernel's plan for this shape on the card, as one phrase."""
    plan = sepconv_kernel.card_plan(device.index or 0, b, h, w, c, co)
    return (f"kc {plan.kc}, nc {plan.nc}, band {plan.band}, grid "
            f"{plan.grid}, {plan.smem} B shared")


def phase_kernel(device: torch.device,
                 shapes=FLAGSHIP_SHAPES + FLAGSHIP_SHAPES_B1 + RAGGED_SHAPES
                 ) -> list[dict]:
    """K1 against its plain version on `device`, timed at the flagship
    shapes (B=8 and B=1) on the card. Tolerance: one bf16 rounding step
    of the output, |k - r| <= 2^-7 |r| + 1e-3, since the kernel sums the
    pointwise product in another order than the plain version's matmul
    (its bf16 depthwise intermediate is bit-identical)."""
    rng = np.random.default_rng(0)
    results = []
    for shape in shapes:
        name, b, h, w, c, co = shape
        x, dw, dwb, pw, pwb = sepconv_inputs(rng, b, h, w, c, co, device)
        rows = row_band(h, 32)
        got = fused_sepconv(x, dw, dwb, pw, pwb, rows=rows)
        ref = sepconv_reference(x, dw, dwb, pw, pwb)
        if device.type == "cuda":
            torch.cuda.synchronize()
        g, r = got.float(), ref.float()
        err = (g - r).abs()
        max_abs = float(err.max())
        max_rel = float((err / r.abs().clamp(min=1e-3)).max())
        ok = bool((err <= 2 ** -7 * r.abs() + 1e-3).all()) and bool(
            torch.isfinite(g).all())
        res = {"name": name, "shape": [b, h, w, c, co],
               "max_abs_err": max_abs, "max_rel_err": max_rel}
        line = (f"{name} B={b} {h}x{w} C={c}->Co={co}: max_abs={max_abs:.3e}"
                f" max_rel={max_rel:.3e} tol=2^-7|r|+1e-3")
        if device.type == "cuda":
            line += f"; {_sepconv_schedule(device, b, h, w, c, co)}"
        if (shape in FLAGSHIP_SHAPES + FLAGSHIP_SHAPES_B1
                and device.type == "cuda"):
            xn = x.permute(0, 3, 1, 2)
            w_dw = dw.reshape(3, 3, c).permute(2, 0, 1)[:, None].to(
                torch.bfloat16).contiguous()
            w_pw = pw.reshape(c, co).t()[:, :, None, None].to(
                torch.bfloat16).contiguous()
            b_dw, b_pw = dwb.to(torch.bfloat16), pwb.to(torch.bfloat16)

            def library():
                y = F.conv2d(xn, w_dw, b_dw, padding=1, groups=c)
                return F.conv2d(y, w_pw, b_pw).clamp_(0.0, 6.0)

            def kernel():
                return fused_sepconv(x, dw, dwb, pw, pwb, rows=rows)

            res.update(both_times("", kernel))
            res.update(both_times(
                "plain_", lambda: sepconv_reference(x, dw, dwb, pw, pwb),
                iters=5))
            res.update(both_times("library_", library))
            res["bound_ms"], res["bound_by"] = sepconv_bound_ms(b, h, w, c, co)
            line += (f"; kernel {res['device_ms']:.4f} ms (host-paced "
                     f"{res['ms']:.4f}), plain "
                     f"{res['plain_device_ms']:.4f} ms, cuDNN pair "
                     f"{res['library_device_ms']:.4f} ms (host-paced "
                     f"{res['library_ms']:.4f}), bound {res['bound_ms']:.4f}"
                     f" ms ({res['bound_by']}), share of the bound "
                     f"{res['bound_ms'] / res['device_ms']:.3f}")
        log("kernel", line)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{name}: max_abs={max_abs}")
        results.append(res)
    if device.type == "cuda":
        card = card_name_and_power()
        for batch in (8, 1):
            sums = flagship_sums(results, batch)
            log("kernel", f"six flagship blocks at B={batch}: kernel "
                f"{sums['device_ms']:.4f} ms (host-paced {sums['ms']:.4f}), "
                f"plain {sums['plain_device_ms']:.4f} ms, cuDNN pair "
                f"{sums['library_device_ms']:.4f} ms (host-paced "
                f"{sums['library_ms']:.4f}), bound {sums['bound_ms']:.4f} "
                f"ms, share of the bound "
                f"{sums['bound_ms'] / sums['device_ms']:.3f}; on {card}")
    return results


# K2 against its plain version: the same Philox words and the same
# float32 operations in the same order, both on the card's libdevice, so
# every element agrees (no element may differ), and so do the per-image
# means.
K2_MAX_DIFFERING = 0.0
K2_MEAN_TOL = 0.0
K2_RATES = (0.5, 5.0, 9.5, 10.5, 200.0)   # constant-image checks


def training_batch(rng, b: int, size: int):
    """(imgs, scales) as the train step gives K2: synthetic micrographs in
    [0, 1] and doses 25 + 75 Exponential(1)."""
    imgs = synthetic_micrographs(b, size, seed=int(rng.integers(2 ** 31)))
    return imgs, (25.0 + 75.0 * rng.exponential(size=b)).astype(np.float32)


def degrade_ops(rate: torch.Tensor, counts: torch.Tensor) -> float:
    """Operations K2 does on this data, each arithmetic operation, compare
    and transcendental counted as one: 96 for the Philox words, 1 for the
    rate, 5 for the min/max and the rescale; below rate 10, 7 plus 5 per
    CDF term the loop reaches (it stops at the count, at most 31); above,
    19 for two uniforms and Box-Muller."""
    small = rate < 10.0
    terms = torch.clamp(counts, max=31.0)
    per = torch.where(small, 7.0 + 5.0 * terms, torch.full_like(rate, 19.0))
    return float((per + 102.0).double().sum())


def degrade_bound_ms(imgs: torch.Tensor, scales: torch.Tensor,
                     counts: torch.Tensor) -> tuple[float, str]:
    """Least time for the card: imgs read once, the output written once
    (and the scales), against this data's operations at the float32
    CUDA-core rate (integer operations included)."""
    nbytes = 8 * imgs.numel() + 4 * scales.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = degrade_ops(imgs * scales[:, None, None], counts) / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _compare_degrade(name: str, seed: int, imgs: torch.Tensor,
                     scales: torch.Tensor, device: torch.device) -> dict:
    before = fused_poisson_degrade.launches
    got = fused_poisson_degrade(seed, imgs, scales)
    launches = fused_poisson_degrade.launches - before
    ref = poisson_degrade_reference(seed, imgs, scales)
    _sync(device)
    diff = (got - ref).abs()
    share = float((diff > 0).double().mean())
    mean_err = float((got.mean(dim=(1, 2)) - ref.mean(dim=(1, 2))).abs().max())
    expected = 1 if device.type == "cuda" else 0
    res = {"name": name, "shape": list(imgs.shape),
           "max_abs_err": float(diff.max()), "differing": share,
           "mean_err": mean_err, "launches_per_call": launches}
    log("degrade", f"{name} {tuple(imgs.shape)}: {share:.3e} of elements "
        f"differ (tol {K2_MAX_DIFFERING}), per-image mean err "
        f"{mean_err:.3e} (tol {K2_MEAN_TOL}), max abs {res['max_abs_err']:.3e}"
        f"; kernel launches in the call {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"K2 launched {launches} kernels in one call "
                             f"at {name}, expected {expected}")
    if not (share <= K2_MAX_DIFFERING and mean_err <= K2_MEAN_TOL
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"K2 disagrees with its plain version at "
                             f"{name}: {res}")
    return res


def _time_degrade(seed: int, imgs: torch.Tensor,
                  scales: torch.Tensor) -> dict:
    """CUDA-event times of K2, its plain version and torch.poisson +
    min/max + rescale (no one call computes the function), and the
    card's least time for this data."""
    def library():
        c = torch.poisson(imgs * scales[:, None, None])
        lo = torch.amin(c, dim=(1, 2), keepdim=True)
        span = torch.amax(c, dim=(1, 2), keepdim=True) - lo
        return torch.where(span > 0, (c - lo) / span, 0.5)

    def kernel():
        return fused_poisson_degrade(seed, imgs, scales)

    # The plain version waits for the card inside a call (device_ms could
    # not queue its calls ahead of the card), so it is timed host-paced.
    out = {**both_times("", kernel), **both_times("library_", library),
           "plain_ms": host_paced_ms(
               lambda: poisson_degrade_reference(seed, imgs, scales),
               iters=5)}
    counts = poisson_counts_reference(seed, imgs, scales)
    rate = imgs * scales[:, None, None]
    out["bound_ms"], out["bound_by"] = degrade_bound_ms(imgs, scales, counts)
    out["ops_ms"] = 1e3 * degrade_ops(rate, counts) / F32_OPS_PER_S
    out["small_rate_share"] = float((rate < 10.0).double().mean())
    return out


def phase_degrade(device: torch.device, b: int = 16,
                  size: int = 512) -> dict:
    """K2 against its plain version on the same Philox stream, and its
    times on the card; the training batch's numbers lead the result."""
    rng = np.random.default_rng(1)
    imgs_np, scales_np = training_batch(rng, b, size)
    cases = [("training", 7, torch.from_numpy(imgs_np).to(device),
              torch.from_numpy(scales_np).to(device))]
    cases += [(f"constant@{rate}", 11,
               torch.ones((4, size, size), device=device),
               torch.full((4,), rate, device=device)) for rate in K2_RATES]
    card = card_name_and_power() if device.type == "cuda" else ""
    results = []
    for name, seed, imgs, scales in cases:
        res = _compare_degrade(name, seed, imgs, scales, device)
        if device.type == "cuda":
            res.update(_time_degrade(seed, imgs, scales))
            plan = degrade_kernel.card_plan(
                device.index or 0, imgs.shape[0],
                imgs.shape[1] * imgs.shape[2])
            log("degrade", f"{name}: one cooperative launch of {plan.grid} "
                f"blocks, {plan.ipb} items of {degrade_kernel.TILE} "
                f"elements each")
            log("degrade", f"{name} {tuple(imgs.shape)}: kernel "
                f"{res['device_ms']:.4f} ms (host-paced {res['ms']:.4f}), "
                f"plain {res['plain_ms']:.4f} ms (host-paced), "
                f"torch.poisson + min/max + rescale "
                f"{res['library_device_ms']:.4f} ms (host-paced "
                f"{res['library_ms']:.4f}), bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
                f"operations alone {res['ops_ms']:.4f} ms); "
                f"rate < 10 on {res['small_rate_share']:.3f} of the "
                f"elements; on {card}")
        results.append(res)
    return {**results[0], "checks": results,
            "max_abs_err": max(r["max_abs_err"] for r in results)}


def smooth_field(rng, h: int, w: int) -> np.ndarray:
    """A smooth synthetic micrograph in [0, 1]: fringes, blobs, slope."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    img = 0.3 + 0.2 * np.sin(2 * np.pi * (rng.uniform(1, 4) * xx
                                          + rng.uniform(0, 1)))
    for _ in range(6):
        cy, cx = rng.uniform(0.1, 0.9, 2)
        s, a = rng.uniform(0.02, 0.12), rng.uniform(0.2, 0.6)
        img = img + a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                               / (2 * s * s))
    img = img + 0.1 * yy
    return scale0to1(torch.from_numpy(img.astype(np.float32))).numpy()


def degrade(rng, clean: np.ndarray, dose: float):
    """(noisy, target): Poisson shot noise at `dose` rescaled to [0, 1],
    and the clean field rescaled to the noisy image's mean."""
    counts = rng.poisson(clean.astype(np.float64) * dose).astype(np.float32)
    noisy = scale0to1(torch.from_numpy(counts)).numpy()
    target = clean * (noisy.mean() / max(float(clean.mean()), 1e-12))
    return noisy.astype(np.float32), target.astype(np.float32)


def post(port: int, img: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, img)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/predict",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)


def _check_output(name: str, out: np.ndarray, shape) -> None:
    if out.shape != tuple(shape):
        raise AssertionError(f"{name}: shape {out.shape}, expected {shape}")
    if not np.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    if out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"{name}: output outside [0, 1]: "
                             f"[{out.min()}, {out.max()}]")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_serve(device: torch.device, cfg: SmokeConfig) -> dict:
    """The main path: serve the bundle over HTTP and check what comes back."""
    rng = np.random.default_rng(0)
    pairs = [degrade(rng, smooth_field(rng, cfg.tile, cfg.tile), DOSE)
             for _ in range(cfg.n_requests)]
    big_clean = smooth_field(rng, *cfg.big_shape)
    big_noisy, _ = degrade(rng, big_clean, DOSE)

    t0 = time.perf_counter()
    srv = serve_artifact(cfg.bundle, tile=cfg.tile, overlap=cfg.overlap,
                         fused_rows=cfg.fused_rows, port=0, device=device)
    log("serve", f"serving {cfg.bundle} on {device} at port {srv.port} "
        f"(fused_rows={cfg.fused_rows}) after "
        f"{time.perf_counter() - t0:.2f} s")
    try:
        fused_sepconv.launches = 0
        outs = [post(srv.port, noisy) for noisy, _ in pairs]
        big = post(srv.port, big_noisy)
        launches = fused_sepconv.launches
        with srv._metrics_lock:
            metrics = dict(srv.metrics)
    finally:
        srv.stop()

    for i, out in enumerate(outs):
        _check_output(f"request {i}", out, (cfg.tile, cfg.tile))
    _check_output("tiled request", big, cfg.big_shape)
    stride = cfg.tile - cfg.overlap
    n_windows = (len(_origins(cfg.big_shape[0], cfg.tile, stride))
                 * len(_origins(cfg.big_shape[1], cfg.tile, stride)))
    tiled_forwards = -(-n_windows // 8)
    forwards = metrics["launches"] - 1 + tiled_forwards
    expected = cfg.launches_per_forward * forwards
    log("serve", f"{len(outs)} native + 1 tiled request ({n_windows} "
        f"windows): {forwards} forwards, K1 launches {launches} "
        f"(expected {expected}); metrics {metrics}")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times, expected "
                             f"{expected} ({cfg.launches_per_forward} per "
                             f"forward x {forwards} forwards)")

    gains = []
    for (noisy, target), out in zip(pairs, outs):
        t = torch.from_numpy(target)
        p_noisy = float(psnr(torch.from_numpy(noisy), t))
        p_out = float(psnr(torch.from_numpy(out), t))
        gains.append(p_out - p_noisy)
        log("serve", f"PSNR noisy {p_noisy:.3f} dB -> denoised "
            f"{p_out:.3f} dB")
    if cfg.min_psnr_gain_db is not None and min(gains) <= cfg.min_psnr_gain_db:
        raise AssertionError(f"denoised PSNR gain {min(gains):.3f} dB is not "
                             f"above {cfg.min_psnr_gain_db} dB")

    # Fused against unfused int8 on the same batch, and forward times.
    _, model, quant = load_denoiser_artifact(cfg.bundle, with_quant=True,
                                             device=device)
    fused = fused_quantized_apply(model, quant["amax"], quant["mode"],
                                  skip=quant.get("skip", ()),
                                  rows=cfg.fused_rows)
    int8 = quantized_apply(model, quant["amax"], quant["mode"],
                           skip=quant.get("skip", ()))
    x = torch.from_numpy(np.stack([n for n, _ in pairs])).to(device)
    a, b = fused(x).float(), int8(x).float()
    _sync(device)
    agree = float(psnr(a, b))
    log("serve", f"fused vs unfused int8 graph on {x.shape[0]} tiles: "
        f"PSNR {agree:.3f} dB (floor {MIN_FUSED_VS_INT8_PSNR_DB} dB)")
    if not agree > MIN_FUSED_VS_INT8_PSNR_DB:
        raise AssertionError(f"fused graph departs from the int8 graph: "
                             f"PSNR {agree:.3f} dB")
    result = {"launches": launches, "forwards": forwards,
              "psnr_gain_db": gains, "fused_vs_int8_psnr_db": agree,
              "forward_ms": {}}
    if device.type == "cuda":
        card = card_name_and_power()
        for bsz in TIMING_BATCHES:
            xb = x[torch.arange(bsz) % x.shape[0]].contiguous()
            # Turns of unfused and fused, in one process on one card.
            for name, fn in (("int8", int8), ("fused", fused),
                             ("fused", fused), ("int8", int8)):
                ms = host_paced_ms(lambda: fn(xb), iters=10, warmup=2)
                key = f"{name}_b{bsz}"
                result["forward_ms"].setdefault(key, []).append(ms)
            log("serve", f"forward at batch {bsz}, ms per {cfg.tile}x"
                f"{cfg.tile} tile: " + ", ".join(
                    f"{k} {[round(v / bsz, 4) for v in vs]}"
                    for k, vs in result["forward_ms"].items()
                    if k.endswith(f"_b{bsz}")) + f" on {card}")
    return result


@dataclasses.dataclass(frozen=True)
class TrainSmokeConfig:
    model: DenoiserConfig = FLAGSHIP_TRAIN
    n_images: int = 64
    size: int = 512
    batch: int = 16
    steps: int = 30
    learning_rate: float = 1e-3
    seed: int = 0
    # Mean loss of the first and the last `window` steps are compared.
    window: int = 10
    # K2 launches per train step (0 where no kernel runs).
    k2_per_step: int = 1


@dataclasses.dataclass(frozen=True)
class DeploySmokeConfig:
    fused_rows: int = 32
    calib_batches: int = 2
    # K1 launches per forward of the served bundle (0 where none runs).
    launches_per_forward: int = 6
    # The folded bf16 model against the BatchNorm bf16 model: bf16 rounds
    # the folded weights and the normalised activations at other places,
    # about 2^-8 of each, through some forty layers.
    min_fold_psnr_db: float = 35.0


def _clone_state(model, optimizer) -> dict:
    """Copies of the model's tensors and of the optimizer's per-parameter
    buffers, keyed by parameter index."""
    return {"model": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "optimizer": {i: {k: (v.clone() if torch.is_tensor(v) else v)
                              for k, v in st.items()}
                          for i, st in optimizer.state_dict()["state"].items()}}


def _same_state(a: dict, b: dict) -> bool:
    if a["model"].keys() != b["model"].keys() or len(a["optimizer"]) != len(
            b["optimizer"]):
        return False
    same = all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for i, st in a["optimizer"].items():
        other = b["optimizer"][i]
        same &= st.keys() == other.keys() and all(
            torch.equal(v, other[k]) if torch.is_tensor(v) else v == other[k]
            for k, v in st.items())
    return same


def phase_train(device: torch.device, cfg: TrainSmokeConfig) -> dict:
    """The training path: Trainer.fit with K2 degrading every batch, a
    checkpoint halfway, then the restore checked. Returns the trained
    model, its corpus and the numbers."""
    t0 = time.perf_counter()
    corpus = synthetic_micrographs(cfg.n_images, cfg.size, seed=cfg.seed)
    model = Denoiser(cfg.model, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    log("train", f"corpus {corpus.shape} and a {n_params:,}-parameter "
        f"model in {time.perf_counter() - t0:.2f} s; TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, TF32 cuDNN "
        f"{torch.backends.cudnn.allow_tf32} (the model computes in "
        f"{cfg.model.dtype})")
    half = cfg.steps // 2
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(learning_rate=cfg.learning_rate,
                           optimizer="nesterov", log_every=1,
                           ckpt_every_steps=half, seed=cfg.seed,
                           model_dir=os.path.join(tmp, "run"))
        trainer = Trainer(model, tcfg, example_fn=denoiser_example)
        state = trainer.init()
        data = DeviceDataset(corpus, PipelineConfig(
            batch_size=cfg.batch, crop_size=cfg.size, seed=cfg.seed),
            device=device)
        ckpt = Checkpointer(os.path.join(tmp, "ckpt"), max_to_keep=2)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        fused_poisson_degrade.launches = 0
        t1 = time.perf_counter()
        trainer.fit(state, data, half, checkpointer=ckpt)
        saved = _clone_state(model, state.optimizer)
        saved_cursor = data.state_dict()
        trainer.fit(state, data, cfg.steps, checkpointer=ckpt)
        _sync(device)
        fit_s = time.perf_counter() - t1
        launches = fused_poisson_degrade.launches
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        lines = read_jsonl(os.path.join(tcfg.model_dir, "metrics.jsonl"))

        fresh = Denoiser(cfg.model, device=device)
        ftrainer = Trainer(fresh, dataclasses.replace(tcfg, model_dir=""))
        fstate, cursor = ckpt.restore(ftrainer.init(), step=half)
        restored = (fstate.step == half and cursor == saved_cursor
                    and _same_state(saved, _clone_state(
                        fresh, fstate.optimizer)))
        del fresh, ftrainer, fstate, saved

    losses = [ln["loss"] for ln in lines]
    if [ln["step"] for ln in lines] != list(range(1, cfg.steps + 1)):
        raise AssertionError(f"metrics.jsonl has steps "
                             f"{[ln['step'] for ln in lines]}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    first = float(np.mean(losses[:cfg.window]))
    last = float(np.mean(losses[-cfg.window:]))
    step_ms = 1e3 * np.diff([ln["t"] for ln in lines])
    med = float(statistics.median(step_ms)) if len(step_ms) else float("nan")
    log("train", f"{cfg.steps} steps of batch {cfg.batch} at {cfg.size}x"
        f"{cfg.size} in {fit_s:.2f} s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, mean of the first {cfg.window} {first:.4f}, of "
        f"the last {last:.4f}")
    log("train", f"median step {med:.2f} ms ({1e3 * cfg.batch / med:.1f} "
        f"img/s; host clock between logged steps, each ending in a read of "
        f"the loss), peak memory {peak / 2 ** 30:.2f} GiB"
        + (f" on {card_name_and_power()}" if device.type == "cuda" else ""))
    log("train", f"K2 launches {launches} (expected "
        f"{cfg.k2_per_step * cfg.steps}); checkpoint {half} restored "
        f"exactly: {restored}")
    if not last < first:
        raise AssertionError(f"loss did not fall: first {cfg.window} steps "
                             f"{first}, last {last}")
    if launches != cfg.k2_per_step * cfg.steps:
        raise AssertionError(f"K2 launched {launches} times in "
                             f"{cfg.steps} steps")
    if not restored:
        raise AssertionError("the halfway checkpoint did not restore the "
                             "saved parameters, buffers, step and cursor")
    return {"model": model, "corpus": corpus, "losses": losses,
            "launches": launches, "step_ms": med, "fit_s": fit_s,
            "img_per_s": 1e3 * cfg.batch / med, "peak_bytes": peak}


def phase_deploy(device: torch.device, trained: dict,
                 cfg: DeploySmokeConfig) -> dict:
    """Fold, calibrate, save and serve the trained model."""
    model = trained["model"].eval()
    corpus = trained["corpus"]
    b = min(16, len(corpus))
    clean = torch.from_numpy(corpus[:b]).to(device)
    fcfg, fparams = fold_denoiser(model.config, *to_flax_params(model))
    folded = load_flax_params(Denoiser(fcfg, device="cpu"), fparams)
    folded = folded.to(device).eval().requires_grad_(False)
    batches = [denoiser_example(1000 + i, clean)[0]
               for i in range(cfg.calib_batches)]
    with torch.inference_mode():
        a = model(batches[0]).float()
        f = folded(batches[0]).float()
    _sync(device)
    agree = float(psnr(f, a))
    log("deploy", f"folded {len(fparams)} arrays; folded against BatchNorm "
        f"model in eval on {b} tiles: PSNR {agree:.2f} dB (floor "
        f"{cfg.min_fold_psnr_db} dB), max abs {float((f - a).abs().max()):.4f}")
    if not agree > cfg.min_fold_psnr_db:
        raise AssertionError(f"folded model departs from the BatchNorm "
                             f"model: PSNR {agree:.2f} dB")
    amax = calibrate(folded, batches)
    rng = np.random.default_rng(5)
    noisy, target = degrade(rng, corpus[-1], DOSE)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bundle.npz")
        save_denoiser_artifact(path, fcfg, {"params": fparams},
                               quant={"mode": "mxu", "amax": amax})
        size_mb = os.path.getsize(path) / 1e6
        srv = serve_artifact(path, fused_rows=cfg.fused_rows, port=0,
                             device=device)
        try:
            fused_sepconv.launches = 0
            out = post(srv.port, noisy)
            launches = fused_sepconv.launches
        finally:
            srv.stop()
    _check_output("deployed request", out, noisy.shape)
    t = torch.from_numpy(target)
    gain = (float(psnr(torch.from_numpy(out), t))
            - float(psnr(torch.from_numpy(noisy), t)))
    log("deploy", f"calibrated {len(amax)} convs on {cfg.calib_batches} "
        f"degraded batches; bundle {size_mb:.1f} MB (temporary); served "
        f"one {noisy.shape[0]}x{noisy.shape[1]} request: K1 launches "
        f"{launches} (expected {cfg.launches_per_forward}); PSNR gain "
        f"{gain:+.3f} dB (reported, not gated: {len(trained['losses'])} "
        f"training steps)")
    if launches != cfg.launches_per_forward:
        raise AssertionError(f"K1 launched {launches} times for one forward,"
                             f" expected {cfg.launches_per_forward}")
    return {"fold_psnr_db": agree, "launches": launches,
            "psnr_gain_db": gain, "n_amax": len(amax)}


def kernels_line(kernel_results: list[dict], launches: int,
                 degrade: dict, degrade_launches: int) -> dict:
    """K1: times summed over the six flagship shapes at B=8 (one B=8
    forward's fused blocks), and at B=1 under `b1`; error over every
    shape checked, launches on the serving path. K2: times at the
    training batch (16, 512, 512), error over every check, launches on
    the training path. `ms`, `plain_ms` and `library_ms` are host-paced,
    as the line has given them from the start; `device_ms` and
    `library_device_ms` are the card's own times (`both_times`)."""
    on_card = any("ms" in r for r in kernel_results)
    sums = flagship_sums(kernel_results, 8) if on_card else {}
    b1 = flagship_sums(kernel_results, 1) if on_card else {}
    return {"kernels": [{
        "name": "K1 fused_sepconv", "route": "cuda",
        "source": "emx_torch/csrc/sepconv.cu",
        "replaces": "emx/ops/sepconv_kernel.py:71",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_results),
        "ms": sums.get("ms"), "plain_ms": sums.get("plain_ms"),
        "bound_ms": sums.get("bound_ms"),
        "bound_by": next((r["bound_by"] for r in kernel_results
                          if "ms" in r and r["shape"][0] == 8), "bytes"),
        "library_ms": sums.get("library_ms"),
        "device_ms": sums.get("device_ms"),
        "library_device_ms": sums.get("library_device_ms"),
        "b1": {k: b1.get(k) for k in TIMED_KEYS},
    }, {
        "name": "K2 fused_poisson_degrade", "route": "cuda",
        "source": "emx_torch/csrc/degrade.cu",
        "replaces": "emx/ops/degrade_kernel.py:39",
        "launches": degrade_launches,
        "max_abs_err": degrade["max_abs_err"],
        "ms": degrade.get("ms"), "plain_ms": degrade.get("plain_ms"),
        "bound_ms": degrade.get("bound_ms"),
        "bound_by": degrade.get("bound_by", "bytes"),
        "library_ms": degrade.get("library_ms"),
        "device_ms": degrade.get("device_ms"),
        "library_device_ms": degrade.get("library_device_ms"),
    }]}


def main() -> None:
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    info = phase_device(device)
    phase_build()
    kernel_results = phase_kernel(device)
    degraded = phase_degrade(device)
    served = phase_serve(device, SmokeConfig())
    trained = phase_train(device, TrainSmokeConfig())
    deployed = phase_deploy(device, trained, DeploySmokeConfig())
    log("train", f"K2 {degraded['device_ms']:.4f} ms of the "
        f"{trained['step_ms']:.2f} ms step: "
        f"{degraded['device_ms'] / trained['step_ms']:.4%}")
    print(json.dumps(kernels_line(kernel_results, served["launches"],
                                  degraded, trained["launches"])),
          flush=True)
    log("done", f"{time.perf_counter() - t0:.1f} s on {info['smi']}; "
        f"deploy K1 launches {deployed['launches']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()

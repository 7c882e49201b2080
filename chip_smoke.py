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
             forward's fused blocks), B=1 (the server's latency regime),
             B=32 (one ladder's forward in the decision and auto phases)
             and B=96 (the serving-rate batch), 128x128, bf16, and two
             ragged ones; the kernel's schedule (channels per pass, band,
             grid, shared memory); at B=8 and B=1 CUDA-event times of
             the kernel, the plain version and the cuDNN depthwise +
             pointwise pair, the card's least time for the same work and
             the share of it the kernel reaches.
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
  8. decision the flagship's DECISION ladder on the card: the five
             ladders rebuilt from the committed Poisson counts
             (docs/runs/port_ladders/ladders.npz) with the identity PSNR
             held to emx's record in that file (+-0.01 dB); the bundle's
             unfused int8 graph (the program DECISION scored) and its
             fused graph on K1 (fused_rows 32), the six classical filters
             and identity, per family. Gates: NN PSNR of both graphs and
             the best classical filter's name and PSNR within +-0.05 dB
             of DECISION.json's row for the bundle, the capped margin
             sum within +-0.1 of its 2.544; K1 launches while the fused
             graph scores; img/s at batch 96 of both graphs.
  9. variants val-ladder PSNR of the 'mxu2', dense int8 and dense bf16
             graphs within +-0.05 dB of serve_perf.json's, and their
             img/s at batch 96.
 10. auto    serve_artifact(bundle, auto=True, fused_rows=32): one request
             per family and one tiled request over HTTP, finite outputs
             of the right shape, /metrics "chosen" counts summing to the
             native requests, K1 launches; on the val ladder auto_denoise's
             output equals, image by image, its chosen candidate's.
 11. export  the bundle's float parameters saved as a directory artifact
             (artifact.json + params.msgpack) and served from it, against
             the float graph; a torch.export round trip of the float
             flagship at batch 1 against eager; the export's seconds.
 12. quality the flagship's training recipe through emx_torch.bench.
             quality_run.main (the `quality` command) at full width: s2d 4,
             norm batch, folded head 128, bf16, remat, batch 16 at 512x512,
             corpus mixed3, cut to 20 steps (the lr drops at step 14) on
             128 images, then resumed to 24 steps. Gates: every logged
             loss finite; quality.json, state_bn.npz and artifact.npz
             written with emx's keys; the folded model within 0.05 dB of
             the BatchNorm model; the second call resumed from step 20
             (logged steps 1..24 once each, lr 1e-4); one K2 launch per
             step; the artifact served over HTTP for one 512x512 request.
 13. qat     the flagship's tail distillation through emx_torch.bench.
             qat_finetune.head_distill (the `qat-finetune --scope=decoder2`
             command) on the flagship bundle's float parameters: mixed3
             (128 images), batch 16, lr 5e-5, mode mxu, cut to 300 steps.
             Gates: the float val PSNR and the bundle's recorded int8
             recipe within 0.05 dB of the bundle's record; the fake-quant
             tail against the int8 graph above 35 dB before and after
             training; finite losses; the QAT PSNR within 1 dB of the
             PTQ one (a fresh calibration, reported); the candidate
             reloaded scores as head_distill scored it (0.001 dB) on the
             five ladders, and its K1-fused graph agrees with its int8
             graph above 35 dB and is not below it by 0.05 dB per family.
             Then 10 steps of qat_finetune.main(target="float") at full
             width: fake-quant against int8 above 35 dB before the first
             step, finite losses.
 14. the kernels line (JSON), then the last line
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

from emx_torch.bench import qat_finetune, quality_run
from emx_torch.bench.flagship_decision import (all_ladders, bundle_graph,
                                               capped_margin_sum,
                                               family_rows, file_sha256,
                                               throughput)
from emx_torch.bench.kernel_times import (FLAGSHIP_BLOCKS, device_ms,
                                          host_paced_ms, sepconv_inputs)
from emx_torch.bench.ladders import (FAMILIES, LADDERS, ladder_record,
                                     load_ladder, mean_psnr)
from emx_torch.bench.serve_latency import get_json
from emx_torch.bench.train_profile import FLAGSHIP_TRAIN
from emx_torch.data import (DeviceDataset, PipelineConfig, denoiser_example,
                            synthetic_micrographs)
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.ops import _build, degrade_kernel, sepconv_kernel
from emx_torch.ops.degrade_kernel import (fused_poisson_degrade,
                                          poisson_counts_reference,
                                          poisson_degrade_reference)
from emx_torch.ops.sepconv_kernel import fused_sepconv, sepconv_reference
from emx_torch.serve.artifact import (load_denoiser_artifact, read_artifact,
                                      save_denoiser_artifact)
from emx_torch.serve.export import (export_compiled, load_compiled,
                                    save_artifact)
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.serve.fused import fused_quantized_apply, row_band
from emx_torch.serve.optimize import fold_denoiser
from emx_torch.serve.quantize import calibrate, quantized_apply
from emx_torch.serve.select import auto_denoise, serving_candidates
from emx_torch.serve.server import AUTO_SEED, serve_artifact
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
# The batches the decision and auto phases give K1: one ladder (32
# images) per forward, and the serving-rate batch. Checked, not timed:
# the kernel takes other row bands there.
LADDER_BATCH = 32
RATE_BATCH = 96
FLAGSHIP_SHAPES_SERVING = tuple((f"{name}@b{b}", b, *rest)
                                for b in (LADDER_BATCH, RATE_BATCH)
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
                 shapes=(FLAGSHIP_SHAPES + FLAGSHIP_SHAPES_B1
                         + FLAGSHIP_SHAPES_SERVING + RAGGED_SHAPES)
                 ) -> list[dict]:
    """K1 against its plain version on `device`, timed at the flagship
    shapes at B=8 and B=1 on the card. Tolerance: one bf16 rounding step
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



# The recorded quality of the flagship bundle: its DECISION.json row (the
# TPU's scores of emx's ladders) and emx's serve_perf.json variant rows.
DECISION_JSON = "docs/runs/flagship/DECISION.json"
SERVE_PERF_JSON = "docs/runs/flagship/serve_perf.json"
# K1 launches per forward of the flagship's fused graph on the card; on
# the CPU the wrapper runs its plain version and launches nothing.
K1_PER_FORWARD = 6


def k1_per_forward(device: torch.device) -> int:
    return K1_PER_FORWARD if device.type == "cuda" else 0


# One bf16 step of a [0, 1] output below 1.0: agreement of two runs of
# the same float graph (a directory artifact, a torch.export program).
BF16_STEP = 2.0 ** -8


def decision_reference(bundle: str, path: str = DECISION_JSON) -> dict:
    """DECISION.json's candidate row for `bundle` (by content hash) and
    the winner's capped margin sum."""
    with open(path) as f:
        dec = json.load(f)
    sha = file_sha256(bundle)
    rows = [r for r in dec["candidates"] if r.get("sha256") == sha]
    if not rows:
        raise AssertionError(f"DECISION.json has no row for {bundle}")
    return {"rows": {f: rows[0][f] for f in FAMILIES},
            "capped_margin_sum": dec["winner_capped_margin_sum"]}


@dataclasses.dataclass(frozen=True)
class DecisionSmokeConfig:
    bundle: str = "docs/runs/flagship/artifact_int8.npz"
    ladders: str = LADDERS
    fused_rows: int = 32
    rate_batch: int = RATE_BATCH
    rate_chain: int = 4
    # Tolerances (dB): rebuilt targets against emx's identity PSNR in the
    # ladder file; NN and best classical against DECISION.json.
    identity_tol_db: float = 0.01
    psnr_tol_db: float = 0.05
    margin_sum_tol: float = 0.1
    # The recorded quality the phases are held to.
    reference: str = DECISION_JSON
    serve_perf: str = SERVE_PERF_JSON


def _gate(failures: list, ok: bool, msg: str) -> None:
    if not ok:
        failures.append(msg)


def phase_decision(device: torch.device, cfg: DecisionSmokeConfig) -> dict:
    """The flagship's DECISION ladder on `device`: both graphs, the
    filters and identity on the five ladders, gated as the docstring of
    this file says."""
    t0 = time.perf_counter()
    ladders, failures = {}, []
    for fam in FAMILIES:
        noisy, clean = load_ladder(fam, device, cfg.ladders)
        ladders[fam] = (noisy, clean)
        got = mean_psnr(noisy, clean)
        want = round(float(np.mean(ladder_record(
            fam, cfg.ladders)["identity_psnr"])), 3)
        log("decision", f"{fam}: ladder {tuple(noisy.shape)} rebuilt; "
            f"identity {got:.3f} dB, emx's {want:.3f} "
            f"(tol {cfg.identity_tol_db})")
        _gate(failures, abs(got - want) <= cfg.identity_tol_db + 1e-9,
              f"{fam} identity {got} vs {want}")
    ladder_s = time.perf_counter() - t0
    unfused, mode = bundle_graph(cfg.bundle, device)
    fused, _ = bundle_graph(cfg.bundle, device, cfg.fused_rows)
    rows = {"unfused": family_rows(unfused, ladders)}
    fused_sepconv.launches = 0
    rows["fused"] = family_rows(fused, ladders)
    launches = fused_sepconv.launches
    expected = k1_per_forward(device) * len(ladders)
    ref = decision_reference(cfg.bundle, cfg.reference)
    for fam in FAMILIES:
        u, f = rows["unfused"][fam], rows["fused"][fam]
        line = (f"{fam}: nn unfused {u['nn_psnr']:.3f} fused "
                f"{f['nn_psnr']:.3f} dB; best classical "
                f"{u['best_classical'][0]} {u['best_classical'][1]:.3f}; "
                f"margin {u['margin']:+.3f}; identity "
                f"{u['identity_psnr']:.3f}")
        r = ref["rows"][fam]
        line += (f" | DECISION nn {r['nn_psnr']:.3f}, "
                 f"{r['best_classical'][0]} {r['best_classical'][1]:.3f},"
                 f" identity {r['identity_psnr']:.3f}")
        for name, row in (("unfused", u), ("fused", f)):
            _gate(failures, abs(row["nn_psnr"] - r["nn_psnr"])
                  <= cfg.psnr_tol_db + 1e-9,
                  f"{fam} {name} nn {row['nn_psnr']} vs {r['nn_psnr']}")
        _gate(failures, u["best_classical"][0] == r["best_classical"][0]
              and abs(u["best_classical"][1] - r["best_classical"][1])
              <= cfg.psnr_tol_db + 1e-9,
              f"{fam} best classical {u['best_classical']} vs "
              f"{r['best_classical']}")
        log("decision", line)
    sums = {k: capped_margin_sum(v) for k, v in rows.items()}
    for k, v in sums.items():
        _gate(failures, abs(v - ref["capped_margin_sum"])
              <= cfg.margin_sum_tol + 1e-9,
              f"{k} capped margin sum {v} vs {ref['capped_margin_sum']}")
    _gate(failures, launches == expected,
          f"K1 launched {launches} times scoring the fused graph, expected "
          f"{expected}")
    rates = {}
    if device.type == "cuda":
        for name, fn in (("unfused", unfused), ("fused", fused),
                         ("unfused", unfused), ("fused", fused)):
            rates.setdefault(name, []).append(throughput(
                fn, device, batch=cfg.rate_batch, chain=cfg.rate_chain))
    seconds = time.perf_counter() - t0
    log("decision", f"capped margin sum unfused {sums['unfused']:.3f}, fused "
        f"{sums['fused']:.3f} (DECISION {ref['capped_margin_sum']})"
        f"; K1 launches {launches} (expected {expected}); img/s at batch "
        f"{cfg.rate_batch}: " + (", ".join(
            f"{k} {[round(v, 1) for v in vs]}" for k, vs in rates.items())
            or "not measured (no card)")
        + f"; ladders {ladder_s:.1f} s, phase {seconds:.1f} s"
        + (f" on {card_name_and_power()}" if device.type == "cuda" else ""))
    if failures:
        raise AssertionError("decision: " + "; ".join(failures))
    return {"rows": rows, "capped_margin_sum": sums, "launches": launches,
            "img_per_s": rates, "seconds": seconds, "mode": mode}


# serve_perf.json's tag of each variant at batch 96 -> bundle_graph's
# keywords.
VARIANTS = (("mxu2/out_float32/b96", {"mode": "mxu2"}),
            ("mxu/dense_int8/b96", {"dense": "int8"}),
            ("mxu/dense_bf16/b96", {"dense": "bf16"}))


def phase_variants(device: torch.device, cfg: DecisionSmokeConfig) -> dict:
    """mxu2 and the dense-folded graphs on the val ladder, held to
    serve_perf.json, and their img/s."""
    noisy, clean = load_ladder("val", device, cfg.ladders)
    with open(cfg.serve_perf) as f:
        ref = {r["variant"]: r for r in json.load(f)["rows"]}
    out, failures = {}, []
    for tag, kw in VARIANTS:
        fn, _ = bundle_graph(cfg.bundle, device, **kw)
        psnr_db = mean_psnr(fn(noisy).float(), clean)
        rate = (throughput(fn, device, batch=cfg.rate_batch,
                           chain=cfg.rate_chain)
                if device.type == "cuda" else None)
        out[tag] = {"psnr": psnr_db, "img_per_s": rate}
        want = ref[tag]["psnr"]
        line = (f"{tag}: val {psnr_db:.3f} dB (serve_perf.json {want:.3f}, "
                f"tol {cfg.psnr_tol_db})")
        _gate(failures, abs(psnr_db - want) <= cfg.psnr_tol_db + 1e-9,
              f"{tag} val {psnr_db} vs {want}")
        line += (f"; {rate:.1f} img/s at batch {cfg.rate_batch} on "
                 f"{card_name_and_power()}" if rate else "")
        log("variants", line)
        del fn
    if failures:
        raise AssertionError("variants: " + "; ".join(failures))
    return out


@dataclasses.dataclass(frozen=True)
class AutoSmokeConfig:
    bundle: str = "docs/runs/flagship/artifact_int8.npz"
    ladders: str = LADDERS
    fused_rows: int = 32
    tile: int = 512
    overlap: int = 80
    big_shape: tuple[int, int] = (1024, 768)
    n_masks: int = 2


def phase_auto(device: torch.device, cfg: AutoSmokeConfig) -> dict:
    """Auto-select serving over HTTP, and auto_denoise against its
    chosen candidates on the val ladder."""
    ladders = {f: load_ladder(f, device, cfg.ladders) for f in FAMILIES}
    reqs = [(f, ladders[f][0][0].cpu().numpy()) for f in FAMILIES]
    big = degrade(np.random.default_rng(3),
                  smooth_field(np.random.default_rng(4), *cfg.big_shape),
                  DOSE)[0]
    srv = serve_artifact(cfg.bundle, tile=cfg.tile, overlap=cfg.overlap,
                         auto=True, auto_n_masks=cfg.n_masks,
                         fused_rows=cfg.fused_rows, port=0, device=device)
    try:
        fused_sepconv.launches = 0
        lat, outs = [], {}
        for fam, img in reqs:
            t = time.perf_counter()
            outs[fam] = post(srv.port, img)
            lat.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        big_out = post(srv.port, big)
        big_ms = 1e3 * (time.perf_counter() - t)
        launches = fused_sepconv.launches
        metrics = get_json(srv.port, "/metrics")
        info = get_json(srv.port, "/healthz")
    finally:
        srv.stop()
    for fam, img in reqs:
        _check_output(f"auto {fam}", outs[fam], img.shape)
    _check_output("auto tiled", big_out, cfg.big_shape)
    chosen = metrics["chosen"]
    stride = cfg.tile - cfg.overlap
    n_windows = (len(_origins(cfg.big_shape[0], cfg.tile, stride))
                 * len(_origins(cfg.big_shape[1], cfg.tile, stride)))
    forwards = (cfg.n_masks + 1) * (metrics["launches"] - 1
                                    + -(-n_windows // 8))
    expected = k1_per_forward(device) * forwards
    log("auto", f"serving {info['auto']}: {len(reqs)} native requests "
        f"(ms {[round(v, 2) for v in lat]}), one {cfg.big_shape} tiled "
        f"request {big_ms:.1f} ms; chosen {chosen}; K1 launches {launches}"
        f" (expected {expected})"
        + (f" on {card_name_and_power()}" if device.type == "cuda" else ""))
    if sum(chosen.values()) != len(reqs):
        raise AssertionError(f"chosen counts {chosen} do not sum to the "
                             f"{len(reqs)} native requests")
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times in auto "
                             f"serving, expected {expected}")
    graph, _ = bundle_graph(cfg.bundle, device, cfg.fused_rows)
    names, cands = serving_candidates(graph)
    noisy = ladders["val"][0]
    out, pick = auto_denoise(noisy, cands, AUTO_SEED, n_masks=cfg.n_masks)
    with torch.inference_mode():
        each = torch.stack([fn(noisy).float() for fn in cands])
    same = [bool(torch.equal(out[i], each[int(c), i]))
            for i, c in enumerate(pick)]
    counts = {n: int((pick == i).sum()) for i, n in enumerate(names)}
    log("auto", f"val ladder: auto_denoise chose {counts}; output equals "
        f"the chosen candidate's on {sum(same)} of {len(same)} images")
    if not all(same):
        raise AssertionError("auto_denoise's output is not its chosen "
                             "candidate's")
    return {"launches": launches, "chosen": chosen, "latency_ms": lat,
            "tiled_ms": big_ms, "val_chosen": counts}


def _nested(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


@dataclasses.dataclass(frozen=True)
class ExportSmokeConfig:
    bundle: str = "docs/runs/flagship/artifact_int8.npz"
    size: int = 512


def phase_export(device: torch.device, cfg: ExportSmokeConfig) -> dict:
    """A directory artifact of the bundle's float parameters served from
    its directory, and a torch.export round trip, each against the
    float graph."""
    config, flat, _ = read_artifact(cfg.bundle)
    conf = {f.name: getattr(config, f.name)
            for f in dataclasses.fields(config)}
    rng = np.random.default_rng(6)
    noisy = degrade(rng, smooth_field(rng, cfg.size, cfg.size), DOSE)[0]
    _, model = load_denoiser_artifact(cfg.bundle, device=device)
    x = torch.from_numpy(noisy[None]).to(device)
    with torch.inference_mode():
        ref = model(x).float()
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "artifact")
        t0 = time.perf_counter()
        save_artifact(art, "denoiser", conf, {"params": _nested(flat)})
        save_s = time.perf_counter() - t0
        size_mb = os.path.getsize(os.path.join(art, "params.msgpack")) / 1e6
        srv = serve_artifact(art, port=0, device=device)
        try:
            served = post(srv.port, noisy)
        finally:
            srv.stop()
        t0 = time.perf_counter()
        export_compiled(os.path.join(tmp, "exported"), model, (x,))
        export_s = time.perf_counter() - t0
        exported = load_compiled(os.path.join(tmp, "exported"))
        with torch.inference_mode():
            again = exported(x).float()
    _sync(device)
    ref_np = ref[0].cpu().numpy()
    err_dir = float(np.abs(served - ref_np).max())
    err_exp = float((again - ref).abs().max())
    log("export", f"directory artifact ({size_mb:.1f} MB params.msgpack, "
        f"saved in {save_s:.2f} s) served: max abs {err_dir:.3e} against "
        f"the float graph; torch.export at batch 1 in {export_s:.1f} s, "
        f"reloaded: max abs {err_exp:.3e} against eager (tol {BF16_STEP})")
    if not (err_dir <= BF16_STEP and err_exp <= BF16_STEP):
        raise AssertionError(f"export: directory artifact {err_dir}, "
                             f"torch.export {err_exp} beyond {BF16_STEP}")
    return {"export_s": export_s, "err_dir": err_dir, "err_export": err_exp}


QUALITY_JSON = "docs/runs/quality_r5/quality.json"   # emx's record


@dataclasses.dataclass(frozen=True)
class QualitySmokeConfig:
    # The flagship's recipe (docs/runs/quality_r5/quality.json), cut:
    # 20 steps, not 60000 (the lr drops at int(0.7 * 20) = 14), then a
    # resumed call to 24; a corpus of 128 images, not 1024.
    steps: int = 20
    resume_steps: int = 24
    batch: int = 16
    s2d: int = 4
    norm: str = "batch"
    folded_head: int = 128
    corpus: str = "mixed3"
    corpus_size: int = 128
    fold_tol_db: float = 0.05
    # K2 launches per train step (0 where no kernel runs).
    k2_per_step: int = 1


def _npz_keys(path: str) -> set:
    with np.load(path) as z:
        return set(z.files)


def phase_quality(device: torch.device, cfg: QualitySmokeConfig) -> dict:
    """quality_run.main twice (the second call resumes), the records it
    writes, and its bundle served; gated as this file's docstring says."""
    failures = []
    with open(QUALITY_JSON) as f:
        emx_keys = set(json.load(f))
    kw = dict(s2d=cfg.s2d, batch=cfg.batch, norm=cfg.norm,
              folded_head=cfg.folded_head, corpus=cfg.corpus,
              corpus_size=cfg.corpus_size, log_every=1, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "quality")
        fused_poisson_degrade.launches = 0
        t0 = time.perf_counter()
        first = quality_run.main(run, steps=cfg.steps, **kw)
        first_s = time.perf_counter() - t0
        written = {name: os.path.exists(os.path.join(run, name))
                   for name in ("quality.json", "state_bn.npz",
                                "artifact.npz")}
        state_keys = _npz_keys(os.path.join(run, "state_bn.npz"))
        art_keys = _npz_keys(os.path.join(run, "artifact.npz"))
        t1 = time.perf_counter()
        second = quality_run.main(run, steps=cfg.resume_steps, **kw)
        second_s = time.perf_counter() - t1
        launches = fused_poisson_degrade.launches
        lines = read_jsonl(os.path.join(run, "metrics.jsonl"))
        ckpt = Checkpointer(os.path.join(run, "ckpt"))
        lr = torch.load(ckpt._path(ckpt.latest_step()), map_location="cpu",
                        weights_only=True)["optimizer"]["param_groups"][0][
                            "lr"]
        with open(os.path.join(run, "quality.json")) as f:
            record = json.load(f)
        size = quality_run.SIZE
        rng = np.random.default_rng(8)
        noisy = degrade(rng, smooth_field(rng, size, size), DOSE)[0]
        srv = serve_artifact(os.path.join(run, "artifact.npz"), port=0,
                             device=device)
        try:
            out = post(srv.port, noisy)
        finally:
            srv.stop()
    _check_output("quality artifact request", out, noisy.shape)
    losses = [ln["loss"] for ln in lines]
    steps = [ln["step"] for ln in lines]
    _gate(failures, bool(np.isfinite(losses).all()),
          f"non-finite loss in {losses}")
    _gate(failures, steps == list(range(1, cfg.resume_steps + 1)),
          f"logged steps {steps}: the second call did not resume at "
          f"{cfg.steps}")
    _gate(failures, (first["steps"], second["steps"])
          == (cfg.steps, cfg.resume_steps),
          f"quality.json steps {first['steps']}, {second['steps']}")
    _gate(failures, all(written.values()), f"records written: {written}")
    _gate(failures, set(record) == emx_keys,
          f"quality.json keys {sorted(set(record) ^ emx_keys)} differ "
          f"from emx's")
    _gate(failures, "__meta_json__" in state_keys and any(
        k.startswith("batch_stats/") for k in state_keys),
        "state_bn.npz lacks batch statistics or meta")
    _gate(failures, "__config_json__" in art_keys
          and not any("BatchNorm" in k for k in art_keys),
          "artifact.npz is not a folded bundle")
    for rec in (first, second):
        _gate(failures, abs(rec["nn_folded_psnr"] - rec["nn_psnr"])
              <= cfg.fold_tol_db + 1e-9,
              f"folded {rec['nn_folded_psnr']} vs BatchNorm "
              f"{rec['nn_psnr']} dB")
    _gate(failures, lr == 1e-4, f"lr at step {cfg.resume_steps} is {lr}")
    expected = cfg.k2_per_step * cfg.resume_steps
    _gate(failures, launches == expected,
          f"K2 launched {launches} times, expected {expected}")
    log("quality", f"cuts: {cfg.steps} steps of 60000 (lr 1e-3 -> 1e-4 at "
        f"step {int(0.7 * cfg.steps)}), resumed to {cfg.resume_steps}; "
        f"corpus {cfg.corpus} of {cfg.corpus_size} images, not 1024")
    log("quality", f"first call {first_s:.1f} s: train_img_per_s "
        f"{first['train_img_per_s']}, nn {first['nn_psnr']} dB, folded "
        f"{first['nn_folded_psnr']}, identity {first['identity_psnr']}, "
        f"best classical {first['best_classical']}, ood {first['ood_psnr']}")
    log("quality", f"resumed call {second_s:.1f} s ({len(lines)} logged "
        f"steps, lr {lr}): train_img_per_s {second['train_img_per_s']}, "
        f"nn {second['nn_psnr']} dB, folded {second['nn_folded_psnr']}; "
        f"K2 launches {launches} (expected {expected}); records "
        f"{sorted(written)}; artifact served a {noisy.shape} request"
        + (f" on {card_name_and_power()}" if device.type == "cuda" else ""))
    if failures:
        raise AssertionError("quality: " + "; ".join(failures))
    return {"launches": launches, "first": first, "second": second,
            "seconds": first_s + second_s}


@dataclasses.dataclass(frozen=True)
class QatSmokeConfig:
    # The flagship's tail distillation (docs/runs/qat_r5/
    # qat_tail_decoder2.json), cut to 300 steps of 12000 on a corpus of
    # 128 images, not 1024.
    bundle: str = "docs/runs/flagship/artifact_int8.npz"
    steps: int = 300
    batch: int = 16
    lr: float = 5e-5
    mode: str = "mxu"
    scope: str = "decoder2"
    corpus: str = "mixed3"
    corpus_size: int = 128
    log_every: int = 25
    fused_rows: int = 32
    float_steps: int = 10
    psnr_tol_db: float = 0.05
    min_tail_psnr_db: float = 35.0
    qat_vs_ptq_db: float = 1.0
    # K2 launches per step, K1 launches per fused forward (0 where no
    # kernel runs).
    k2_per_step: int = 1
    k1_per_forward: int = 6


def _keeping(fn, outs: list):
    """`fn`, keeping each output in `outs`."""
    def wrapped(x):
        y = fn(x)
        outs.append(y.float())
        return y
    return wrapped


def phase_qat(device: torch.device, cfg: QatSmokeConfig) -> dict:
    """head_distill on the bundle's float parameters, its candidate
    reloaded and scored unfused and K1-fused, then a few steps of the
    full-model fake-quant finetune; gated as this file's docstring
    says."""
    failures = []
    quant = read_artifact(cfg.bundle)[2]
    with tempfile.TemporaryDirectory() as tmp:
        fused_poisson_degrade.launches = 0
        t0 = time.perf_counter()
        out = qat_finetune.head_distill(
            cfg.bundle, tmp, cfg.steps, cfg.batch, cfg.lr, mode=cfg.mode,
            scope=cfg.scope, corpus=cfg.corpus,
            corpus_size=cfg.corpus_size, log_every=cfg.log_every,
            device=device)
        distill_s = time.perf_counter() - t0
        k2_distill = fused_poisson_degrade.launches
        ladders = all_ladders(device)
        recipe, _ = bundle_graph(cfg.bundle, device)
        recipe_psnr = mean_psnr(recipe(ladders["val"][0]), ladders["val"][1])
        unfused, _ = bundle_graph(out["candidate_bundle"], device)
        fused, _ = bundle_graph(out["candidate_bundle"], device,
                                cfg.fused_rows)
        u_outs, f_outs = [], []
        rows = {"unfused": family_rows(_keeping(unfused, u_outs), ladders)}
        fused_sepconv.launches = 0
        rows["fused"] = family_rows(_keeping(fused, f_outs), ladders)
        k1 = fused_sepconv.launches
        agree = [float(psnr(f, u)) for f, u in zip(f_outs, u_outs)]
        del recipe, unfused, fused, ladders, u_outs, f_outs
        fused_poisson_degrade.launches = 0
        t1 = time.perf_counter()
        fout = qat_finetune.main(cfg.bundle, tmp, cfg.float_steps,
                                 cfg.batch, target="float",
                                 corpus_size=cfg.corpus_size, log_every=1,
                                 device=device)
        float_s = time.perf_counter() - t1
        k2_float = fused_poisson_degrade.launches
    for name, got, want in (("float", out["float_psnr"],
                             quant["float_psnr"]),
                            ("recorded-recipe ptq", recipe_psnr,
                             quant["psnr"])):
        _gate(failures, abs(got - want) <= cfg.psnr_tol_db + 1e-9,
              f"{name} psnr {got} vs the bundle's {want}")
    tail = out["tail_int8_psnr"]
    for when in ("before", "after"):
        _gate(failures, tail[when] > cfg.min_tail_psnr_db,
              f"fake-quant tail against the int8 graph {when} training: "
              f"{tail[when]} dB")
    losses = out["loss_trace"] + fout["loss_trace"]
    _gate(failures, len(out["loss_trace"]) == cfg.steps // cfg.log_every
          and bool(np.isfinite(losses).all()), f"loss traces {losses}")
    _gate(failures, abs(out["qat_psnr"] - out["ptq_psnr"])
          <= cfg.qat_vs_ptq_db, f"qat {out['qat_psnr']} vs ptq "
          f"{out['ptq_psnr']} dB")
    for fam, a in zip(FAMILIES, agree):
        u, f = rows["unfused"][fam]["nn_psnr"], rows["fused"][fam]["nn_psnr"]
        own = out["families"][fam]["nn_psnr"]
        # The reloaded candidate scores as head_distill scored it; its
        # fused graph (six blocks on K1 in bf16, not int8) agrees with
        # the int8 graph and loses nothing to it.
        _gate(failures, abs(u - own) <= 1e-3 + 1e-9,
              f"{fam} reloaded candidate {u} vs head_distill's {own} dB")
        _gate(failures, a > MIN_FUSED_VS_INT8_PSNR_DB,
              f"{fam} fused against unfused outputs {a:.3f} dB")
        _gate(failures, f >= u - cfg.psnr_tol_db - 1e-9,
              f"{fam} candidate fused {f} below unfused {u} dB")
        log("qat", f"candidate {fam}: unfused {u:.3f} (head_distill "
            f"{own:.3f}), fused {f:.3f} ({f - u:+.3f}), outputs agree at "
            f"{a:.2f} dB; best classical "
            f"{rows['unfused'][fam]['best_classical']}")
    _gate(failures, fout["fq_int8_psnr"] > cfg.min_tail_psnr_db,
          f"full-model fake quant against int8 {fout['fq_int8_psnr']} dB")
    want_k2 = cfg.k2_per_step * (cfg.steps + 1 + cfg.float_steps)
    want_k1 = cfg.k1_per_forward * len(FAMILIES)
    _gate(failures, k2_distill + k2_float == want_k2,
          f"K2 launched {k2_distill} + {k2_float} times, expected {want_k2}")
    _gate(failures, k1 == want_k1,
          f"K1 launched {k1} times scoring the fused candidate, expected "
          f"{want_k1}")
    log("qat", f"cuts: {cfg.steps} steps of 12000, corpus {cfg.corpus} of "
        f"{cfg.corpus_size} images, not 1024; full-model main "
        f"{cfg.float_steps} steps")
    log("qat", f"float {out['float_psnr']} (bundle {quant['float_psnr']}), "
        f"the bundle's recorded recipe {recipe_psnr} (bundle "
        f"{quant['psnr']}), ptq after a fresh calibration "
        f"{out['ptq_psnr']} (reported), qat {out['qat_psnr']}, qat float "
        f"{out['qat_float_psnr']} dB; tail against int8 {tail}; capped "
        f"margin sum {out['capped_margin_sum']}; ood "
        f"{out['ood_psnr_before']} -> {out['ood_psnr']}")
    log("qat", f"loss trace {out['loss_trace']}; distillation "
        f"{out['train_s']} s ({cfg.steps / max(out['train_s'], 1e-9):.2f} "
        f"steps/s), head_distill {distill_s:.1f} s, qat img/s "
        f"{out['qat_img_per_s']}; K2 launches {k2_distill} + {k2_float} "
        f"(expected {want_k2}), K1 {k1} (expected {want_k1})")
    log("qat", f"main(target=float) {cfg.float_steps} steps in {float_s:.1f}"
        f" s: fake quant against int8 {fout['fq_int8_psnr']} dB before the "
        f"first step, losses {fout['loss_trace']}, qat {fout['qat_psnr']}; "
        f"phase {time.perf_counter() - t0:.1f} s"
        + (f" on {card_name_and_power()}" if device.type == "cuda" else ""))
    if failures:
        raise AssertionError("qat: " + "; ".join(failures))
    return {"k2_launches": k2_distill + k2_float, "k1_launches": k1,
            "distill": out, "float": fout, "rows": rows, "agree": agree,
            "recipe_psnr": recipe_psnr, "seconds": distill_s + float_s}


def kernels_line(kernel_results: list[dict], launches: int,
                 degrade: dict, degrade_launches: int,
                 phase_launches: dict | None = None,
                 degrade_phase_launches: dict | None = None) -> dict:
    """K1: times summed over the six flagship shapes at B=8 (one B=8
    forward's fused blocks), and at B=1 under `b1`; error over every
    shape checked, launches on the serving path. K2: times at the
    training batch (16, 512, 512), error over every check, launches on
    the training path; each kernel's `phase_launches` counts each path
    that runs it (K2's when given). `ms`, `plain_ms` and `library_ms` are host-paced,
    as the line has given them from the start; `device_ms` and
    `library_device_ms` are the card's own times (`both_times`)."""
    on_card = any("ms" in r for r in kernel_results)
    sums = flagship_sums(kernel_results, 8) if on_card else {}
    b1 = flagship_sums(kernel_results, 1) if on_card else {}
    k2_phases = ({"phase_launches": degrade_phase_launches}
                 if degrade_phase_launches else {})
    return {"kernels": [{
        "name": "K1 fused_sepconv", "route": "cuda",
        "source": "emx_torch/csrc/sepconv.cu",
        "replaces": "emx/ops/sepconv_kernel.py:71",
        "launches": launches,
        "phase_launches": phase_launches or {"serve": launches},
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
        **k2_phases,
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
    trained_launches = trained["launches"]
    deployed = phase_deploy(device, trained, DeploySmokeConfig())
    log("train", f"K2 {degraded['device_ms']:.4f} ms of the "
        f"{trained['step_ms']:.2f} ms step: "
        f"{degraded['device_ms'] / trained['step_ms']:.4%}")
    del trained
    quality = phase_quality(device, QualitySmokeConfig())
    decided = phase_decision(device, DecisionSmokeConfig())
    phase_variants(device, DecisionSmokeConfig())
    auto = phase_auto(device, AutoSmokeConfig())
    phase_export(device, ExportSmokeConfig())
    qat = phase_qat(device, QatSmokeConfig())
    print(json.dumps(kernels_line(
        kernel_results, served["launches"], degraded, trained_launches,
        {"serve": served["launches"], "deploy": deployed["launches"],
         "decision": decided["launches"], "auto": auto["launches"],
         "qat": qat["k1_launches"]},
        {"train": trained_launches, "quality": quality["launches"],
         "qat": qat["k2_launches"]})), flush=True)
    log("done", f"{time.perf_counter() - t0:.1f} s on {info['smi']}; "
        f"deploy K1 launches {deployed['launches']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()

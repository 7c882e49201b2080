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
             per call; at the training batch also captured in a CUDA
             graph with its seed in a device tensor, each replay (a new
             seed copied in) identical to the plain version, and timed;
             its schedule; times of the kernel, the plain version and
             torch.poisson + min/max + rescale, and the card's least
             time for this data.
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
  8. graph   the train phase's config (BatchNorm, bf16, s2d 4, folded
             head 128, remat, batch 16 at 512x512, nesterov) run as
             Trainer(steps_per_launch=8): from one state, 8 eager steps
             and one replay of a CUDA graph of 8 steps (K2 inside it, its
             Philox key read from a device tensor) must agree in every
             step's loss and in the parameters, buffers and optimizer
             state (cudnn deterministic); then 32 eager steps against 4
             replays: step ms, img/s, capture seconds, peak memory, and
             from one profiled window each the device's busy ms and idle
             share, kernels per step, the host's kernel and graph launches
             per step and K2's device ms per step.
  9. files   the microscopist's path through `python -m emx_torch.cli`:
             a DM corpus (8 imaging 2048x2048 micrographs, one 3000x2600,
             and three to reject: under min_side, spectroscopy mode,
             truncated) written with the port's write_dm; `harvest`
             (census, manifest count, stats keys); the loader's img/s on
             the harvested TIFFs; `train-denoiser` at the CLI's default
             full width (group norm, s2d 2), batch 8 of 512x512 crops,
             steps_per_launch 8, 16 steps, then resumed from its
             checkpoint to 24 (the cursor exact, the losses finite, one K2
             launch a step); its directory artifact served over HTTP for
             a 512x512 and a 1000x700 request.
  10. decision the flagship's DECISION ladder on the card: the five
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
  11. variants val-ladder PSNR of the 'mxu2', dense int8 and dense bf16
             graphs within +-0.05 dB of serve_perf.json's, and their
             img/s at batch 96.
 12. auto    serve_artifact(bundle, auto=True, fused_rows=32): one request
             per family and one tiled request over HTTP, finite outputs
             of the right shape, /metrics "chosen" counts summing to the
             native requests, K1 launches; on the val ladder auto_denoise's
             output equals, image by image, its chosen candidate's.
 13. export  the bundle's float parameters saved as a directory artifact
             (artifact.json + params.msgpack) and served from it, against
             the float graph; a torch.export round trip of the float
             flagship at batch 1 against eager; the export's seconds.
 14. quality the flagship's training recipe through emx_torch.bench.
             quality_run.main (the `quality` command) at full width: s2d 4,
             norm batch, folded head 128, bf16, remat, batch 16 at 512x512,
             corpus mixed3, cut to 20 steps (the lr drops at step 14) on
             128 images, then resumed to 24 steps. Gates: every logged
             loss finite; quality.json, state_bn.npz and artifact.npz
             written with emx's keys; the folded model within 0.05 dB of
             the BatchNorm model; the second call resumed from step 20
             (logged steps 1..24 once each, lr 1e-4); one K2 launch per
             step; the artifact served over HTTP for one 512x512 request.
 15. qat     the flagship's tail distillation through emx_torch.bench.
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
 16. gan     `python -m emx_torch.cli train-infilling` at the reference's
             full width (InfillingConfig(), float32), batch 4 of 512x512
             synthetic crops, 12 steps with a checkpoint every 4, then
             resumed to 16: per-step d_fake, d_real and trainee, ms a
             step, img/s, peak memory. Gates: every loss finite, both
             nets' parameters changed, the resumed state's digest equal to
             the saved one's.
 17. gan_quality  emx_torch.bench.gan_quality.main on the committed state
             docs/runs/gan_quality_300k/gan_state.npz (its sha256 printed;
             missing: the phase fails), eval only (steps = its step
             125000; scale 0.5, 256x256, coverage 1/64), with the val
             images' fingerprint. Gates: the NN row within +-0.10 dB of
             its quality.json (25.784), each classical row and identity
             within +-0.02 dB. Then 20 training steps from that warm
             start, steps/s.
 18. gan_demo emx_torch.bench.gan_demo.main cut to 200 steps (a
             checkpoint at 100 before the simulated collapse) and its
             150-step starvation segment. Gates: a rollback, a forced
             switch, both nets trained.
 19. ewrec   ewrec_bench.measure(15, 512, 50): GS iterations/s of the
             Fourier-averaged and naive loops and the FFT-only ceiling;
             accuracy_vs_dose(15, 256, 50) and ewrec_diagnosis.main(256,
             15): every accuracy row, gs_corr_vs_iters and
             weak_phase_corr within +-0.001 of docs/runs/ewrec_r4_
             accuracy.json and ewrec_r5_diagnosis.json; then `python -m
             emx_torch.cli ewrec` on a focal series of five 128x128 TIFFs
             (known wave, defocus step 300, subpixel shifts): complex
             |corr| above 0.95 and the defocus step within 10%.
 20. zoo     emx_torch.bench.zoo_ladder.main on every family (small_ae,
             xception_ae, latent_ae, embedder, kernels, vaegan, manifold,
             embedder_nce and the three vaegan variants) at the records'
             scale 0.25 and size 96, cut to 40-3500 steps of the records'
             4000/16000 (ZooSmokeConfig.family_steps), under cuDNN's
             deterministic algorithms. Gates against
             docs/runs/zoo_ladder*/quality.json: every anchor made from
             numpy data alone
             (anchor_const_psnr, chance, anchor_identity_psnr) within
             +-0.01; losses finite, the last below the first; small_ae,
             xception_ae and latent_ae above their const anchor and the
             kernel bank's best above the Gaussian filter. Then five steps
             of each family's full-width (scale 1) config: steps/s, step
             ms and peak GiB of steps 2-5.
 21. style   emx_torch.bench.style_artifact.main uncut (800 steps at
             128^2, style weight 2000) on docs/runs/port_style/inputs.npz
             (emx's feature parameters and canvas noise; the artifact
             runs cuDNN's deterministic algorithms): gram_gap_closed
             and content_correlation within +-0.02 of docs/runs/style_r3/
             quality.json and within +-0.01 of emx's own CPU run recorded
             in the inputs file; seconds and steps/s.
 22. scope   the live-microscope path. emx_torch.bench.dqn_vec.main on
             the committed policy docs/runs/dqn_autofocus_v2/policy.npz
             uncut: the six serial rows (50 episodes each), traced. Every
             DQN step's Q values within 1e-5 of the policy's float64
             numpy forward (dqn.reference_q_values) on the same
             observation, no greedy action off it but at a near-tie; the
             card's noiseless frames off focus within 2e-5 of the CPU's;
             each row held episode by episode to emx's trace of the
             record's run (docs/runs/port_dqn_eval/emx_trace.json) while
             the frames' digests agree (dqn_vec.compare_traces: no
             fault); each row's metrics within DQN_ROW_TOL of the span of
             the record and of emx's 200 runs with its propagation
             changed in the last bits (docs/runs/port_dqn_eval/
             emx_nudged_rows.json); the random row's solve rate, steps,
             return and distance, which no frame moves, equal to
             quality.json's; the record's four
             true-target comparisons, dqn_true_target's solve rate
             within +-0.2 and the vec greedy evaluation
             (solve rate >= 0.95, mean final distance <= 0.10). Then the
             vec trainer at dqn_vec's configuration for 300 iterations
             of 128 lanes: env steps/s, gradient steps/s, finite losses,
             and a profiled window (idle share, kernels an iteration);
             `emx_torch.cli.main(["dqn-autofocus", ...])` for 3 episodes;
             the fringe classifier on the simulator's labels (24 a class
             at 32^2, 300 steps): accuracy above 0.8, the loss falling.
 23. sweep   emx_torch.bench.sweep.measure on base16 (the bf16
             group-norm Denoiser, batch 16 at 512x512) for 5 launches:
             img/s, ms a launch.
 24. parallel emx_torch.parallel over a one-rank NCCL group
             (initialize() at a free local port; one all_reduce): the
             graph phase's flagship config, 6 eager steps under
             make_mesh_for_batch(16) against 6 without a mesh (every loss
             and the whole state equal; one K2 launch a step; step ms of
             both), then under the mesh one replay of a CUDA graph of 8
             steps against 8 eager steps (equal); K2 at the training
             batch with image_offset 3 and 8 on rows [k:], equal to the
             whole launch's rows and to the plain version, eagerly and
             captured; one 4096x4096 micrograph (smooth_field at dose 100)
             through spatial_apply with the bundle's K1-fused int8 graph
             on a spatial mesh of 1 (halo max(80, halo_grid()) rounded to
             the grid), against tiled_apply (512/80) and the full-image
             pass: emx's rule err_halo <= max(2 err_tiled, 5e-3), six K1
             launches, K1 held at the six blocks' shapes there; seconds
             and peak GiB; halo_denoise of the bundle's float Denoiser
             at 2048x2048 to the same rule; dryrun_multichip(1) in the
             group.
 25. the kernels line (JSON), then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
     No GAN, EWREC, zoo, style, scope or sweep function reaches K1 or
     K2: emx computes them with XLA convolutions and jnp.fft, the port
     with cuDNN and cuFFT; the line's phase counts for them say so (0).
     The parallel phase's counts are the meshed steps' and the replay's
     K2 launches and the halo forward's K1 launches.

Inputs are made from fixed seeds with numpy; the weights of the trained
model from a seed. The phases are functions of (device, config), so the
CPU tests rehearse the ones that need no kernel on tiny configs.
"""

from __future__ import annotations

import contextlib
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
from emx_torch.serve.export import (export_compiled, load_compiled, nest,
                                    save_artifact)
from emx_torch.serve.convert import load_flax_params, to_flax_params
from emx_torch.serve.fused import fused_quantized_apply, row_band
from emx_torch.serve.optimize import fold_denoiser
from emx_torch.serve.quantize import calibrate, quantized_apply
from emx_torch.serve.select import auto_denoise, serving_candidates
from emx_torch.serve.server import AUTO_SEED, serve_artifact
from emx_torch.serve.tiling import _origins
from emx_torch.train import Checkpointer, TrainConfig, Trainer
from emx_torch.train.engine import WARMUP_STEPS
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
    try:   # the port reads TIFF without PIL; whether the machine has it
        import PIL
        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = "no PIL"
    log("device", f"{kind}; device_count={count}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}; {pil}")
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

    key = degrade_kernel.seed_tensor(seed, imgs.device)

    def kernel():
        return fused_poisson_degrade(key, imgs, scales)

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


def degrade_under_capture(imgs: torch.Tensor, scales: torch.Tensor,
                          seeds: tuple[int, ...]) -> dict:
    """K2 captured in a CUDA graph with its Philox key in a device tensor,
    then replayed once per seed (each copied into the key first): every
    replay against the plain version, element for element; and the time
    of a replay (one K2 launch)."""
    key = degrade_kernel.seed_tensor(seeds[0], imgs.device)
    fused_poisson_degrade(key, imgs, scales)       # plan and occupancy
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_poisson_degrade(key, imgs, scales)
    checks = []
    for seed in seeds:
        key.copy_(degrade_kernel.seed_tensor(seed, imgs.device))
        graph.replay()
        ref = poisson_degrade_reference(seed, imgs, scales)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        checks.append({"seed": seed, "max_abs_err": float(diff.max()),
                       "differing": float((diff > 0).double().mean())})
    return {"checks": checks, **both_times("captured_", graph.replay)}


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
            if name == "training":
                cap = degrade_under_capture(imgs, scales, (seed, seed + 1))
                res["captured"] = cap
                log("degrade", f"{name} under CUDA graph capture (the "
                    f"cooperative launch captured), seed in a device "
                    f"tensor: " + ", ".join(
                        f"seed {c['seed']}: {c['differing']:.3e} of elements "
                        f"differ, max abs {c['max_abs_err']:.3e}"
                        for c in cap["checks"])
                    + f"; a replay {cap['captured_device_ms']:.4f} ms "
                    f"(host-paced {cap['captured_ms']:.4f})")
                if any(c["differing"] > K2_MAX_DIFFERING
                       for c in cap["checks"]):
                    raise AssertionError(f"captured K2 disagrees with its "
                                         f"plain version: {cap['checks']}")
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


@dataclasses.dataclass(frozen=True)
class GraphSmokeConfig:
    """The train phase's flagship config, run eagerly and as CUDA graphs
    of `k` steps (Trainer(steps_per_launch=k))."""
    model: DenoiserConfig = FLAGSHIP_TRAIN
    n_images: int = 64
    size: int = 512
    batch: int = 16
    k: int = 8
    optimizer: str = "nesterov"
    learning_rate: float = 1e-3
    seed: int = 0
    # Eager steps before the comparison, so the optimizer state exists.
    pre_steps: int = 2
    timed_replays: int = 4
    # Graph against eager, in parameters, buffers, optimizer state and
    # each step's loss: exact under cudnn.deterministic.
    tol: float = 0.0
    # K2 launches per train step (0 where no kernel runs).
    k2_per_step: int = 1


def _restore_in_place(model, optimizer, saved: dict) -> None:
    """Write `_clone_state`'s copies back into the live tensors."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(saved["model"][k])
        for i, st in saved["optimizer"].items():
            live = optimizer.state[params[i]]
            for k, v in st.items():
                if torch.is_tensor(v):
                    live[k].copy_(v)


def _max_state_diff(a: dict, b: dict) -> float:
    diffs = [float((a["model"][k].double() - b["model"][k].double())
                   .abs().max()) for k in a["model"]]
    for i, st in a["optimizer"].items():
        diffs += [float((v.double() - b["optimizer"][i][k].double())
                        .abs().max()) for k, v in st.items()
                  if torch.is_tensor(v)]
    return max(diffs)


def phase_graph(device: torch.device, cfg: GraphSmokeConfig) -> dict:
    """From one state, `k` eager steps and one replay of a CUDA graph of
    `k` steps (K2 inside it) must agree in every step's loss and in the
    parameters, buffers and optimizer state; then 32 eager steps are
    timed against 4 replays, and one of each is profiled."""
    from emx_torch.bench.forward_profile import profile_forward

    was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        corpus = synthetic_micrographs(cfg.n_images, cfg.size,
                                       seed=cfg.seed)
        model = Denoiser(cfg.model, device=device)
        tcfg = TrainConfig(learning_rate=cfg.learning_rate,
                           optimizer=cfg.optimizer, log_every=0,
                           seed=cfg.seed)
        eager = Trainer(model, tcfg, example_fn=denoiser_example)
        graphed = Trainer(model, dataclasses.replace(
            tcfg, steps_per_launch=cfg.k), example_fn=denoiser_example)
        state = eager.init()
        data = DeviceDataset(corpus, PipelineConfig(
            batch_size=cfg.batch, crop_size=cfg.size, seed=cfg.seed),
            device=device)
        k2_before = fused_poisson_degrade.launches
        eager.fit(state, data, cfg.pre_steps)
        start = _clone_state(model, state.optimizer)
        cursor, step0 = data.state_dict(), state.step

        it = iter(data)
        rows = [torch.stack([m[k] for k in ("loss", "mse", "grad_norm")])
                for m in (eager.step_fn(state, next(it))[1]
                          for _ in range(cfg.k))]
        eager_losses = torch.stack(rows)[:, 0].tolist()
        after_eager = _clone_state(model, state.optimizer)

        _restore_in_place(model, state.optimizer, start)
        state.step = step0
        data.load_state_dict(cursor)
        it = iter(data)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        metrics = graphed._launch(state, [next(it) for _ in range(cfg.k)])
        _sync(device)
        graph_losses = metrics[:, 0].tolist()
        after_graph = _clone_state(model, state.optimizer)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        stats = graphed.graph_stats
        state_diff = _max_state_diff(after_eager, after_graph)
        loss_diff = max(abs(a - b) for a, b in zip(eager_losses,
                                                   graph_losses))
        log("graph", f"one replay of {cfg.k} steps against {cfg.k} eager "
            f"steps from step {step0}: losses {graph_losses} / "
            f"{eager_losses}; max |loss difference| {loss_diff:.3e}, max "
            f"|parameter, buffer, optimizer-state difference| "
            f"{state_diff:.3e} (tolerance {cfg.tol}; cudnn deterministic)")
        log("graph", f"capture {stats['capture_s']:.2f} s (after "
            f"{WARMUP_STEPS} warm-up steps, undone); K2 launches per replay "
            f"{graphed.graph.k2_per_replay} (expected "
            f"{cfg.k2_per_step * cfg.k}); peak memory "
            f"{peak / 2 ** 30:.2f} GiB")
        if not (loss_diff <= cfg.tol and state_diff <= cfg.tol):
            raise AssertionError(f"the graph departs from eager: loss "
                                 f"{loss_diff}, state {state_diff}")
        if graphed.graph.k2_per_replay != cfg.k2_per_step * cfg.k:
            raise AssertionError(f"K2 launched {graphed.graph.k2_per_replay}"
                                 f" times in a graph of {cfg.k} steps")

        result = {"loss_diff": loss_diff, "state_diff": state_diff,
                  "capture_s": stats["capture_s"], "peak_bytes": peak,
                  "k2_per_replay": graphed.graph.k2_per_replay}
        # Timed with cuDNN's own choice of algorithms, as training runs:
        # the graph is captured again under it, before the clock starts.
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was
        graphed.graph = None
        if device.type == "cuda":
            graphed._launch(state, [next(it) for _ in range(cfg.k)])
            n_eager = cfg.timed_replays * cfg.k

            def timed(fn, n):
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                _sync(device)
                return time.perf_counter() - t0

            eager_s = timed(lambda: eager.step_fn(state, next(it)), n_eager)
            graph_s = timed(lambda: graphed._launch(
                state, [next(it) for _ in range(cfg.k)]),
                cfg.timed_replays)
            prof_e = profile_forward(
                lambda _: eager.step_fn(state, next(it)), None, n=cfg.k,
                match="degrade_")
            prof_g = profile_forward(
                lambda _: graphed._launch(state, [next(it) for _ in
                                                  range(cfg.k)]),
                None, n=1, match="degrade_")
            card = card_name_and_power()
            for name, secs, prof, per in (("eager", eager_s, prof_e, 1),
                                          ("graph", graph_s, prof_g, cfg.k)):
                step_ms = 1e3 * secs / n_eager
                result[name] = {
                    "step_ms": step_ms, "img_per_s": 1e3 * cfg.batch / step_ms,
                    "profiled_step_ms": prof["wall_ms"] / per,
                    "device_busy_ms": prof["device_busy_ms"] / per,
                    "idle_share": prof["idle_share"],
                    "kernels_per_step": prof["kernels_per_forward"] / per,
                    "host_kernel_launches_per_step":
                        prof["host_kernel_launches"] / per,
                    "graph_launches_per_step": prof["graph_launches"] / per,
                    "k2_device_ms_per_step": prof["matched_ms"] / per}
                r = result[name]
                log("graph", f"{name}: {step_ms:.2f} ms a step over "
                    f"{n_eager} steps ({r['img_per_s']:.1f} img/s); "
                    f"profiled: {r['profiled_step_ms']:.2f} ms, device busy "
                    f"{r['device_busy_ms']:.2f} ms, idle share "
                    f"{r['idle_share']:.3f}, {r['kernels_per_step']:.1f} "
                    f"kernels a step from {r['host_kernel_launches_per_step']:.2f}"
                    f" host kernel launches and {r['graph_launches_per_step']:.3f}"
                    f" graph launches, K2 {r['k2_device_ms_per_step']:.4f} ms a "
                    f"step; on {card}")
        stats = graphed.graph_stats
        result["launches"] = (fused_poisson_degrade.launches - k2_before
                              - stats["captures"] * graphed.graph.k2_per_replay
                              + stats["k2_replayed"])
        result["graph_stats"] = dict(stats)
        return result
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was


@dataclasses.dataclass(frozen=True)
class FilesSmokeConfig:
    """The microscopist's path through `python -m emx_torch.cli`: a DM
    corpus, `harvest`, `train-denoiser` from the harvested TIFFs (as a
    CUDA graph of `steps_per_launch` steps), its resume, and the artifact
    served."""
    n_micrographs: int = 8          # imaging 2048x2048, DM3 and DM4
    size: int = 2048
    odd_shape: tuple[int, int] = (3000, 2600)   # the non-integer resize
    small_side: int = 400                       # under min_side 512
    harvest_size: int = 2048
    batch: int = 8
    crop: int = 512
    steps: int = 16
    resume_steps: int = 24
    steps_per_launch: int = 8
    ckpt_every: int = 8
    # DenoiserConfig().scaled(scale): 1.0 is the CLI's default width.
    scale: float = 1.0
    request_shapes: tuple = ((512, 512), (1000, 700))
    loader_batches: int = 6
    k2_per_step: int = 1
    seed: int = 0


def write_dm_corpus(root: str, cfg: FilesSmokeConfig) -> dict:
    """Imaging micrographs (synthetic_micrographs as counts), one of
    odd_shape, and three files harvest must reject: one under min_side,
    one in spectroscopy mode, one truncated. Returns the census expected."""
    from emx_torch.io.dm import write_dm

    imgs = synthetic_micrographs(cfg.n_micrographs, cfg.size, seed=cfg.seed)
    for i, im in enumerate(imgs):
        write_dm(os.path.join(root, f"m{i}.dm{3 + i % 2}"),
                 (im * 900 + 40).astype(np.float32))
    odd = synthetic_micrographs(1, max(cfg.odd_shape), seed=cfg.seed + 1)[0]
    write_dm(os.path.join(root, "odd.dm4"), (odd[:cfg.odd_shape[0],
             :cfg.odd_shape[1]] * 900 + 40).astype(np.float32))
    write_dm(os.path.join(root, "small.dm3"),
             (imgs[0, :cfg.small_side, :cfg.small_side] * 900 + 40)
             .astype(np.float32))
    write_dm(os.path.join(root, "spectrum.dm3"),
             (imgs[1] * 900 + 40).astype(np.float32),
             operation_mode="SPECTROSCOPY")
    raw = open(os.path.join(root, "m0.dm3"), "rb").read()
    with open(os.path.join(root, "truncated.dm3"), "wb") as f:
        f.write(raw[:len(raw) // 2])
    usable = cfg.n_micrographs + 1
    return {"total": usable + 3, "decode_failed": 1, "not_imaging": 1,
            "too_small": 1, "too_dim": 0, "usable": usable}


def _cli(*argv: str, phase: str = "files") -> list[str]:
    """Run `python -m emx_torch.cli` in a subprocess; its stdout lines.
    It fails the phase if the command fails."""
    import subprocess
    import sys

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "emx_torch.cli", *argv],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise AssertionError(f"emx_torch.cli {argv[0]} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    log(phase, f"emx_torch.cli {argv[0]} done in "
        f"{time.perf_counter() - t0:.1f} s")
    return proc.stdout.splitlines()


def phase_files(device: torch.device, cfg: FilesSmokeConfig) -> dict:
    """harvest a DM corpus, train-denoiser on the harvested TIFFs (the
    CLI's default full width, steps_per_launch a CUDA graph), resume it
    from its checkpoint, and serve its directory artifact over HTTP."""
    import ast

    from emx_torch.bench.pipeline_bench import loader_rate
    from emx_torch.data.pipeline import DataPipeline
    from emx_torch.physics.stats import STAT_NAMES

    dev = device.type
    with tempfile.TemporaryDirectory() as tmp:
        dm_dir, out, run = (os.path.join(tmp, d)
                            for d in ("dm", "harvested", "run"))
        os.makedirs(dm_dir)
        t0 = time.perf_counter()
        expected = write_dm_corpus(dm_dir, cfg)
        log("files", f"DM corpus of {expected['total']} files in "
            f"{time.perf_counter() - t0:.1f} s")
        lines = _cli("harvest", f"--src={dm_dir}", f"--out={out}",
                     f"--size={cfg.harvest_size}", f"--device={dev}")
        census = ast.literal_eval(lines[0].removeprefix("census: "))
        records = [json.loads(x) for x in open(
            os.path.join(out, "manifest_0.jsonl"))]
        log("files", f"census {census}; {len(records)} micrographs reaped")
        if census != expected or len(records) != expected["usable"]:
            raise AssertionError(f"harvest: census {census}, "
                                 f"{len(records)} records; expected "
                                 f"{expected}")
        if any(set(r["stats"]) != set(STAT_NAMES) for r in records):
            raise AssertionError("harvest: stats keys are not STAT_NAMES")

        paths = sorted(r["path"] for r in records)
        loader = loader_rate(DataPipeline(paths, PipelineConfig(
            batch_size=cfg.batch, crop_size=cfg.crop, seed=cfg.seed)),
            n_batches=cfg.loader_batches)
        log("files", f"DataPipeline on the harvested TIFFs: {loader:.1f} "
            f"img/s (batch {cfg.batch} of {cfg.crop}x{cfg.crop} crops of "
            f"{cfg.harvest_size}x{cfg.harvest_size} float32 TIFFs, "
            f"median of 3 windows of {cfg.loader_batches})")

        train = [f"--data_dir={out}", f"--model_dir={run}",
                 f"--batch_size={cfg.batch}", f"--crop_size={cfg.crop}",
                 f"--steps_per_launch={cfg.steps_per_launch}",
                 f"--ckpt_every_steps={cfg.ckpt_every}",
                 f"--scale={cfg.scale}", f"--seed={cfg.seed}",
                 f"--device={dev}"]
        first = json.loads(_cli("train-denoiser", *train,
                                f"--steps={cfg.steps}")[-1])
        lines = _cli("train-denoiser", *train,
                     f"--steps={cfg.resume_steps}")
        second = json.loads(lines[-1])
        resumed = lines[0]
        # Each step launches K2, and so does each warm-up step before a
        # capture (run eagerly, then undone).
        k2_expected = [(cfg.k2_per_step if dev == "cuda" else 0)
                       * (n + WARMUP_STEPS * r["graph"]["captures"])
                       for n, r in ((cfg.steps, first),
                                    (cfg.resume_steps - cfg.steps, second))]
        for name, res in (("first", first), ("resumed", second)):
            log("files", f"train-denoiser {name}: steps {res['start']} -> "
                f"{res['step']}, loss {res['loss']:.4f}, "
                f"{res['img_per_s']:.1f} img/s over the whole fit (capture "
                f"{res['graph']['capture_s']:.2f} s included; "
                f"{res['graph']['replays']} replays), K2 launches "
                f"{res['k2_launches']}, cursor {res['cursor']}")
        want_resume = (f"resumed from step {cfg.steps} at cursor "
                       f"{first['cursor']}")
        if resumed != want_resume:
            raise AssertionError(f"train-denoiser resumed as {resumed!r}, "
                                 f"expected {want_resume!r}")
        if not (first["step"] == cfg.steps
                and second["step"] == cfg.resume_steps
                and np.isfinite([first["loss"], second["loss"]]).all()):
            raise AssertionError(f"train-denoiser: {first}, {second}")
        if [first["k2_launches"], second["k2_launches"]] != k2_expected:
            raise AssertionError(f"K2 launched {first['k2_launches']}, "
                                 f"{second['k2_launches']} times; expected "
                                 f"{k2_expected}")

        srv = serve_artifact(os.path.join(run, "artifact"), port=0,
                             device=device)
        try:
            rng = np.random.default_rng(cfg.seed + 7)
            for shape in cfg.request_shapes:
                noisy, _ = degrade(rng, smooth_field(rng, *shape), DOSE)
                _check_output(f"files request {shape}", post(srv.port, noisy),
                              noisy.shape)
        finally:
            srv.stop()
        log("files", f"the artifact served {len(cfg.request_shapes)} "
            f"requests {list(cfg.request_shapes)} over HTTP")
    return {"census": census, "loader_img_per_s": loader,
            "train": [first, second],
            "launches": first["k2_launches"] + second["k2_launches"]}


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
        save_artifact(art, "denoiser", conf, {"params": nest(flat)})
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


# ---------------------------------------------------------------------------
# The infilling GAN and exit-wave reconstruction.

@dataclasses.dataclass(frozen=True)
class GanSmokeConfig:
    # `train-infilling` at the reference's full width (InfillingConfig(),
    # float32), batch 4 of 512x512 crops, cut to 12 steps of 700000, then
    # resumed from the step-12 checkpoint to 16.
    steps: int = 12
    resume_steps: int = 16
    batch: int = 4
    crop: int = 512
    ckpt_every: int = 4
    scale: float = 1.0


def phase_gan(device: torch.device, cfg: GanSmokeConfig) -> dict:
    """train-infilling twice through the CLI (the second call resumes);
    gated on finite losses, both nets changed, and the resumed state's
    digest equal to the saved one's."""
    failures = []
    common = (f"--batch_size={cfg.batch}", f"--crop_size={cfg.crop}",
              f"--ckpt_every_steps={cfg.ckpt_every}", "--log_every=1",
              f"--scale={cfg.scale}", f"--device={device.type}")
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "infilling")
        outs = []
        for steps in (cfg.steps, cfg.resume_steps):
            lines = _cli("train-infilling", f"--model_dir={run}",
                         f"--steps={steps}", *common, phase="gan")
            outs.append(json.loads(lines[-1]))
        recs = read_jsonl(os.path.join(run, "metrics.jsonl"))
    first, second = outs
    steps_logged = [r["step"] for r in recs if "gen_loss" in r]
    _gate(failures, steps_logged == list(range(1, cfg.resume_steps + 1)),
          f"logged steps {steps_logged}")
    _gate(failures, all(np.isfinite(r[k]) for r in recs if "gen_loss" in r
                        for k in ("gen_loss", "disc_loss")),
          "a non-finite loss")
    _gate(failures, first["changed"] == {"gen": True, "disc": True},
          f"parameters changed: {first['changed']}")
    _gate(failures, second["resumed"] is not None
          and second["resumed"]["step"] == cfg.steps
          and second["resumed"]["digest"] == first["digest"],
          f"resumed {second['resumed']} against the saved state "
          f"{first['digest']} at step {first['step']}")
    _gate(failures, second["step"] == cfg.resume_steps,
          f"resumed run ended at step {second['step']}")
    for r in recs:
        if "gen_loss" in r:
            log("gan", f"step {r['step']}: d_fake {r['d_fake']:.4f} d_real "
                f"{r['d_real']:.4f} gen_loss {r['gen_loss']:.4f} disc_loss "
                f"{r['disc_loss']:.4f} trainee "
                f"{'G' if r['train_gen'] else 'D'} (next step)")
    for name, rec in (("first", first), ("resumed", second)):
        log("gan", f"{name} call: steps {rec['start']}->{rec['step']}, "
            f"{rec['ms_per_step']:.2f} ms/step, {rec['img_per_s']:.2f} "
            f"img/s (batch {cfg.batch} at {cfg.crop}x{cfg.crop}; the "
            f"process's first steps), peak "
            + (f"{rec['peak_gib']:.2f} GiB" if rec["peak_gib"] is not None
               else "n/a (CPU)"))
    # Steady state: the logged steps' spacing (each step ends in a read of
    # its metrics), past each process's first two steps.
    t = {r["step"]: r["t"] for r in recs if "gen_loss" in r}
    gaps = [1e3 * (t[i] - t[i - 1]) for i in t if i - 1 in t
            and i not in (1, 2, cfg.steps + 1, cfg.steps + 2)]
    steady = statistics.median(gaps) if gaps else None
    if steady:
        log("gan", f"steady state: {steady:.2f} ms a step (median of "
            f"{len(gaps)}), {1e3 * cfg.batch / steady:.2f} img/s")
    prof = gan_profile(device, cfg) if device.type == "cuda" else None
    if failures:
        raise AssertionError("gan: " + "; ".join(failures))
    return {"first": first, "second": second, "steady_ms": steady,
            "profile": prof}


def gan_profile(device: torch.device, cfg: GanSmokeConfig) -> dict:
    """The train-infilling step in this process, with torch's default
    TF32 convolutions as the CLI runs it: 3 warm-up steps, 4 profiled
    (generator and discriminator steps alternating): wall and device
    busy ms, idle share, kernels a step, the costliest kernels."""
    from emx_torch.bench.forward_profile import profile_forward
    from emx_torch.data.degrade import fixed_scan_mask, infilling_example
    from emx_torch.nn.infilling import (InfillingConfig, InfillingGenerator,
                                        MultiscaleDiscriminator)
    from emx_torch.train.gan import GANConfig, GANTrainer

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        net = InfillingConfig().scaled(cfg.scale) if cfg.scale != 1.0 \
            else InfillingConfig()
        trainer = GANTrainer(
            InfillingGenerator(net, device=device),
            MultiscaleDiscriminator(net, device=device),
            GANConfig(log_every=0),
            example_fn=infilling_example(fixed_scan_mask(
                (cfg.crop, cfg.crop), 1 / 64)))
        state = trainer.init()
        data = iter(DeviceDataset(
            synthetic_micrographs(2 * cfg.batch, cfg.crop),
            PipelineConfig(batch_size=cfg.batch, crop_size=cfg.crop),
            device=device))
        turn = iter(range(1 << 30))

        def step(_):
            gen_turn = next(turn) % 2 == 0
            trainer.step_fn(state, next(data), gen_turn, not gen_turn)

        torch.cuda.reset_peak_memory_stats(device)
        res = profile_forward(step, None, n=4)
        res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log("gan", f"profiled step (TF32 convolutions, as the CLI): "
        f"{res['wall_ms']:.2f} ms wall, {res['device_busy_ms']:.2f} ms "
        f"device busy, idle {res['idle_share']:.3f}, "
        f"{res['kernels_per_forward']:.0f} kernels a step, peak "
        f"{res['peak_gib']:.2f} GiB; top {res['top_kernels_ms'][:6]}")
    return res


GAN_STATE = "docs/runs/gan_quality_300k/gan_state.npz"
GAN_QUALITY_JSON = "docs/runs/gan_quality_300k/quality.json"


@dataclasses.dataclass(frozen=True)
class GanQualitySmokeConfig:
    # The committed state (step 125000, scale 0.5, size 256, mse_weight
    # 100, coverage 64) scored as its record was (eval only), then a few
    # training steps from the same warm start.
    state: str = GAN_STATE
    record: str = GAN_QUALITY_JSON
    batch: int = 8
    train_steps: int = 20
    corpus_size: int = 1024
    nn_tol_db: float = 0.10
    classical_tol_db: float = 0.02


def phase_gan_quality(device: torch.device,
                      cfg: GanQualitySmokeConfig) -> dict:
    """gan_quality.main on the committed state: NN, classical and identity
    rows against its quality.json; then train_steps steps from it."""
    from emx_torch.bench import gan_quality
    from emx_torch.bench.ladders import fingerprint

    if not os.path.exists(cfg.state):
        raise FileNotFoundError(f"{cfg.state} is missing: the phase scores "
                                "the committed GAN state")
    with open(cfg.record) as f:
        rec = json.load(f)
    with np.load(cfg.state) as z:
        meta = json.loads(bytes(z["__meta_json__"]).decode())
    log("gan_quality", f"{cfg.state} sha256 {file_sha256(cfg.state)}; "
        f"meta {meta}")
    size, coverage = meta["size"], meta["coverage"]
    kw = dict(batch=cfg.batch, size=size, scale=meta["scale"],
              mse_weight=meta["mse_weight"], init_from=cfg.state,
              coverage=coverage, corpus_size=cfg.corpus_size,
              device=device)
    _, clean, _ = gan_quality.val_scans(size, coverage, device)
    fp = fingerprint(clean).sum(dim=0).tolist()
    log("gan_quality", f"val images (synthetic_micrographs(32, {size}, "
        f"seed=999) in [-1, 1]) fingerprint sums {fp!r}")
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        got = gan_quality.main(os.path.join(tmp, "eval"),
                               steps=meta["step"], **kw)
        eval_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        trained = gan_quality.main(os.path.join(tmp, "train"),
                                   steps=meta["step"] + cfg.train_steps,
                                   log_every=1, **kw)
        train_s = time.perf_counter() - t1
    _gate(failures, got["steps"] == meta["step"] == rec["steps"],
          f"scored step {got['steps']}, record {rec['steps']}")
    rows = {"nn": cfg.nn_tol_db, **{k: cfg.classical_tol_db
                                    for k in rec["all"] if k != "nn"}}
    for k, tol in rows.items():
        diff = got["all_exact"][k] - rec["all"][k]
        log("gan_quality", f"{k}: port {got['all_exact'][k]:.4f} dB, "
            f"record {rec['all'][k]} dB, diff {diff:+.4f} (gate +-{tol})")
        _gate(failures, abs(diff) <= tol, f"{k} off by {diff:+.4f} dB")
    diff = got["identity_exact"] - rec["identity_psnr_masked"]
    log("gan_quality", f"identity: port {got['identity_exact']:.4f} dB, "
        f"record {rec['identity_psnr_masked']} dB, diff {diff:+.4f}")
    _gate(failures, abs(diff) <= cfg.classical_tol_db,
          f"identity off by {diff:+.4f} dB")
    _gate(failures, trained["steps"] == meta["step"] + cfg.train_steps
          and np.isfinite(trained["nn_psnr_masked"]),
          f"warm-start training ended at {trained['steps']}, nn "
          f"{trained['nn_psnr_masked']}")
    log("gan_quality", f"eval-only call {eval_s:.1f} s; {cfg.train_steps} "
        f"training steps from the warm start (batch {cfg.batch} at "
        f"{size}x{size}, scale {meta['scale']}, bf16): "
        f"{trained['train_step_per_s']} steps/s, then nn "
        f"{trained['nn_psnr_masked']} dB; call {train_s:.1f} s")
    if failures:
        raise AssertionError("gan_quality: " + "; ".join(failures))
    return {"scored": got, "trained": trained}


@dataclasses.dataclass(frozen=True)
class GanDemoSmokeConfig:
    # emx's demo (256x256, batch 8, half widths) cut to 200 steps: a
    # checkpoint at step 100 comes before the collapse at the midpoint.
    steps: int = 200


def phase_gan_demo(device: torch.device, cfg: GanDemoSmokeConfig) -> dict:
    """gan_demo.main: at least one rollback, one forced switch, and both
    nets trained."""
    from emx_torch.bench import gan_demo

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = gan_demo.main(tmp, steps=cfg.steps, device=device)
        seconds = time.perf_counter() - t0
    failures = []
    _gate(failures, out["rollbacks"] >= 1, "no rollback")
    _gate(failures, out["forced_switches"] >= 1, "no forced switch")
    _gate(failures, out["both_trained"], "one net never trained")
    total = cfg.steps + gan_demo.STARVE_STEPS
    log("gan_demo", f"{out}; {seconds:.1f} s for {total} loop steps, "
        f"{1e3 * seconds / total:.1f} ms a step (with its per-step logging"
        f" and checkpoints)")
    if failures:
        raise AssertionError("gan_demo: " + "; ".join(failures))
    return out


EWREC_ACCURACY_JSON = "docs/runs/ewrec_r4_accuracy.json"
EWREC_DIAGNOSIS_JSON = "docs/runs/ewrec_r5_diagnosis.json"


@dataclasses.dataclass(frozen=True)
class EwrecSmokeConfig:
    # emx's budgets: 15 slices, 512^2 for the rates, 256^2 for accuracy
    # and the diagnosis, 50 GS iterations.
    n_slices: int = 15
    rate_side: int = 512
    side: int = 256
    num_iter: int = 50
    tol: float = 0.001
    check_records: bool = True
    cli_side: int = 128


FOCAL_STEP = 300.0   # defocus step of the CLI's focal series (Angstrom)


def write_focal_series(root: str, n: int, seed: int = 3) -> np.ndarray:
    """A known exit wave imaged at five defocuses FOCAL_STEP apart, each
    slice translated by a known subpixel shift, as TIFFs numbered in
    defocus order; returns the wave. The wave is scripts/e2e_drive.py's
    (smooth phase bumps) with a band-limited texture in its phase (0.3
    rad rms) and amplitude (0.05 rms): without it, phase correlation of
    the defocused slices does not lock, and its amplitude alone would
    reach 0.95 of the wave (0.93 with it)."""
    from emx_torch.io.tiff import write_tiff
    from emx_torch.physics.propagate import propagate_back_to_defocus
    from emx_torch.recon import fourier_shift

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    amp = 1.0 + 0.1 * np.sin(2 * np.pi * (2 * xx + yy))
    phase = np.zeros((n, n), np.float32)
    for _ in range(4):
        cy, cx = rng.uniform(0.2, 0.8, 2)
        sg = rng.uniform(0.05, 0.15)
        phase += rng.uniform(0.2, 0.8) * np.exp(
            -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sg ** 2)))
    k = np.fft.fftfreq(n)
    tex = np.fft.ifft2(np.fft.fft2(rng.random((n, n))) * np.exp(
        -(k[:, None] ** 2 + k[None, :] ** 2) / (2 * 0.15 ** 2))).real
    tex = (tex - tex.mean()) / tex.std()
    wave = ((amp + 0.05 * tex) * np.exp(1j * (phase + 0.3 * tex))
            ).astype(np.complex64)
    dfs = FOCAL_STEP * torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0])
    shifts = torch.tensor([[1.5, -2.0], [0.5, 1.0], [0.0, 0.0],
                           [-1.25, 0.5], [2.0, 1.5]])
    with torch.no_grad():
        stack = torch.abs(propagate_back_to_defocus(
            torch.from_numpy(wave), dfs, 0.025)) ** 2
        stack = fourier_shift(stack, shifts)
    os.makedirs(root, exist_ok=True)
    for i, img in enumerate(stack.numpy()):
        write_tiff(os.path.join(root, f"slice_{i:02d}.tif"),
                   img.astype(np.float32))
    return wave


def phase_ewrec(device: torch.device, cfg: EwrecSmokeConfig) -> dict:
    """GS rates, the accuracy and diagnosis rows against emx's records,
    and `ewrec` through the CLI on a focal series of TIFFs."""
    from emx_torch.bench import ewrec_bench, ewrec_diagnosis
    from emx_torch.io.tiff import read_tiff

    failures = []
    t0 = time.perf_counter()
    rates = ewrec_bench.measure(cfg.n_slices, cfg.rate_side, cfg.num_iter,
                                device=device)
    log("ewrec", f"{json.dumps(rates)}"
        + (f" on {card_name_and_power()}" if device.type == "cuda" else ""))
    acc = ewrec_bench.accuracy_vs_dose(cfg.n_slices, cfg.side, cfg.num_iter,
                                       device=device)
    diag = ewrec_diagnosis.main(cfg.side, cfg.n_slices, device=device)
    if cfg.check_records:
        with open(EWREC_ACCURACY_JSON) as f:
            ref_acc = json.load(f)["complex_corr"]
        with open(EWREC_DIAGNOSIS_JSON) as f:
            ref_diag = json.load(f)
        rows = [(f"accuracy {k}", acc["complex_corr"][k], v)
                for k, v in ref_acc.items()]
        rows += [(f"gs_corr_vs_iters {k}", diag["gs_corr_vs_iters"][k], v)
                 for k, v in ref_diag["gs_corr_vs_iters"].items()]
        rows.append(("weak_phase_corr", diag["weak_phase_corr"],
                     ref_diag["weak_phase_corr"]))
        for name, got, ref in rows:
            log("ewrec", f"{name}: port {got}, record {ref}")
            _gate(failures, abs(got - ref) <= cfg.tol + 1e-9,
                  f"{name} {got} against {ref}")
    with tempfile.TemporaryDirectory() as tmp:
        stack_dir = os.path.join(tmp, "stack")
        out_dir = os.path.join(tmp, "out")
        wave = write_focal_series(stack_dir, cfg.cli_side)
        lines = _cli("ewrec", f"--stack_dir={stack_dir}", f"--out={out_dir}",
                     f"--num_iter={cfg.num_iter}", f"--device={device.type}",
                     phase="ewrec")
        rec = read_tiff(os.path.join(out_dir, "amplitude.tif")) * np.exp(
            1j * read_tiff(os.path.join(out_dir, "phase.tif")))
    def corr_with_wave(w):
        return abs(np.vdot(w, wave)) / (np.linalg.norm(w)
                                        * np.linalg.norm(wave))

    corr = corr_with_wave(rec)
    dfs = json.loads(lines[0].split(":", 1)[1])
    step = (dfs[-1] - dfs[0]) / (len(dfs) - 1)
    log("ewrec", f"cli: {' | '.join(lines)}; defocus step {step:.2f} "
        f"(true {FOCAL_STEP}); complex |corr| {corr:.4f} against the known "
        f"wave (gate > 0.95; its amplitude alone "
        f"{corr_with_wave(np.abs(wave)):.4f})")
    _gate(failures, corr > 0.95, f"cli reconstruction corr {corr:.4f}")
    _gate(failures, abs(step - FOCAL_STEP) <= 0.1 * FOCAL_STEP,
          f"cli defocus step {step:.2f}, true {FOCAL_STEP}")
    log("ewrec", f"{time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("ewrec: " + "; ".join(failures))
    return {"rates": rates, "accuracy": acc, "diagnosis": diag,
            "cli_corr": corr}


ZOO_RECORDS = ("docs/runs/zoo_ladder/quality.json",
               "docs/runs/zoo_ladder_ext/quality.json",
               "docs/runs/zoo_ladder_ext2/quality.json",
               "docs/runs/zoo_ladder_ext3/quality.json")
# The anchors a family computes from numpy data alone (no draw, no
# training): they must equal emx's records.
ZOO_ANCHORS = ("anchor_const_psnr", "chance", "anchor_identity_psnr")
# (first, last) loss keys of each family's result.
ZOO_LOSSES = (("first_loss", "final_loss"), ("first_mse", "final_mse"),
              ("first_recon_loss", "final_recon_loss"))
# The families run once at full width: the ladder's scale-1 configs.
ZOO_FULL_WIDTH = ("small_ae", "xception_ae", "latent_ae", "embedder",
                  "vaegan", "manifold")


def zoo_records(paths=ZOO_RECORDS) -> dict:
    """Every family's result in emx's zoo records, the later files' over
    the earlier (the 16000-step runs over the 4000-step ones)."""
    out = {}
    for path in paths:
        with open(path) as f:
            out.update(json.load(f)["families"])
    return out


@dataclasses.dataclass(frozen=True)
class ZooSmokeConfig:
    # The records' scale and size, each family cut to `steps` (4000 and
    # 16000 in the records) unless `family_steps` says otherwise; the
    # cut runs take cuDNN's deterministic algorithms, so that each gate
    # reads the same number on every run of one card and library. The
    # reconstruction gates need small_ae past ~1000 steps and latent_ae
    # past ~3250: its PSNR sits on its anchor (15.25) for the first
    # thousands of steps, and over seeds 0-4 it is above it at every
    # 250th step from 3250 on, by +0.66 to +1.93 dB at 3500, where at
    # 2000 seed 2 is under it (-0.10; seed 0 +0.03;
    # scripts/zoo_latent_curve.py on an H100). The others, at 13-65 ms a
    # step, are cut to what their gates need.
    scale: float = 0.25
    size: int = 96
    steps: int = 120
    family_steps: tuple = (("small_ae", 1200), ("latent_ae", 3500),
                           ("embedder", 300), ("kernels", 200),
                           ("vaegan", 60), ("vaegan_kl01", 40),
                           ("vaegan_anneal", 40), ("vaegan_wass01", 40))
    anchor_tol: float = 0.01
    full_width: tuple = ZOO_FULL_WIDTH
    full_width_steps: int = 5


def zoo_gates(results: dict, records: dict, anchor_tol: float) -> list[str]:
    """The zoo phase's gates on zoo_ladder results: no family errored;
    every numpy-only anchor equals the record's within `anchor_tol`;
    losses finite and the last below the first; the reconstruction
    families' PSNR above their const anchor and the kernel bank's best
    above the Gaussian filter (the directions every 4000-step record
    shows)."""
    from emx_torch.bench.zoo_ladder import RECON_FAMILIES

    failures = []
    for name, r in results.items():
        if "error" in r:
            failures.append(f"{name}: {r['error']}")
            continue
        rec = records.get(name, {})
        for k in ZOO_ANCHORS:
            if k in r and k in rec:
                _gate(failures, abs(r[k] - rec[k]) <= anchor_tol + 1e-9,
                      f"{name} {k} {r[k]} against the record's {rec[k]}")
        for first, last in ZOO_LOSSES:
            if first in r:
                _gate(failures, np.isfinite(r[first])
                      and np.isfinite(r[last]) and r[last] < r[first],
                      f"{name} {last} {r[last]} not below {first} "
                      f"{r[first]}")
        if name in RECON_FAMILIES:
            _gate(failures, r["psnr"] > r["anchor_const_psnr"],
                  f"{name} psnr {r['psnr']} not above its const anchor "
                  f"{r['anchor_const_psnr']}")
        if name == "kernels":
            _gate(failures, r["best_psnr"] > r["anchor_gaussian_psnr"],
                  f"kernels best {r['best_psnr']} not above the Gaussian "
                  f"{r['anchor_gaussian_psnr']}")
    return failures


def _launch_counts() -> tuple[int, int]:
    return fused_sepconv.launches, fused_poisson_degrade.launches


def phase_zoo(device: torch.device, cfg: ZooSmokeConfig) -> dict:
    """emx_torch.bench.zoo_ladder.main on every family at the records'
    scale and size, cut; zoo_gates against emx's records; then each
    full-width family for a few steps: steps/s, step ms, peak GiB. No K1
    or K2 launch (the zoo's convolutions are cuDNN's, as emx's were
    XLA's)."""
    from emx_torch.bench import zoo_ladder

    names = list(zoo_ladder.FAMILIES)
    steps_of = {n: dict(cfg.family_steps).get(n, cfg.steps) for n in names}
    before = _launch_counts()
    results, t0 = {}, time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for steps in sorted(set(steps_of.values())):
            group = [n for n in names if steps_of[n] == steps]
            out = zoo_ladder.main(os.path.join(tmp, f"cut{steps}"), steps,
                                  cfg.scale, cfg.size, families=group,
                                  device=device, deterministic=True)
            results.update(out["families"])
    cut_s = time.perf_counter() - t0
    records = zoo_records()
    failures = zoo_gates(results, records, cfg.anchor_tol)
    card = f" on {card_name_and_power()}" if device.type == "cuda" else ""
    for name in names:
        r, rec = results[name], records.get(name, {})
        rate = (f"{r['steps_per_s']} steps/s, {r['step_ms']} ms a step, "
                f"peak {r['peak_gib']} GiB" if "steps_per_s" in r
                else "no rate (CPU)")
        log("zoo", f"{name} ({steps_of[name]} steps at scale {cfg.scale}, "
            f"{cfg.size}^2): {json.dumps(r)}; {rate}; emx's record (TPU, "
            f"longer run) "
            f"{json.dumps({k: v for k, v in rec.items() if k != 'seconds'})}")
    full = {}
    for name in cfg.full_width:
        t1 = time.perf_counter()
        r = zoo_ladder.FAMILIES[name](cfg.full_width_steps, 1.0, cfg.size,
                                      device=device)
        full[name] = r
        _gate(failures, "error" not in r and all(
            np.isfinite(r[k]) for pair in ZOO_LOSSES for k in pair
            if k in r), f"full-width {name}: {r}")
        rate = (f"{r['steps_per_s']} steps/s, {r['step_ms']} ms a step "
                f"(steps 2-{cfg.full_width_steps}, the evaluation after "
                f"them not counted), peak {r['peak_gib']} GiB"
                if "steps_per_s" in r else "no rate (CPU)")
        log("zoo", f"full width {name}: {rate}; call "
            f"{time.perf_counter() - t1:.1f} s")
    after = _launch_counts()
    _gate(failures, after == before,
          f"K1/K2 launches moved {before} -> {after}")
    log("zoo", f"cut ladder {cut_s:.1f} s, whole phase "
        f"{time.perf_counter() - t0:.1f} s{card}; K1/K2 launches in the "
        f"phase: {after[0] - before[0]}/{after[1] - before[1]}")
    if failures:
        raise AssertionError("zoo: " + "; ".join(failures))
    return {"cut": results, "full_width": full,
            "launches": (after[0] - before[0], after[1] - before[1])}


STYLE_JSON = "docs/runs/style_r3/quality.json"


@dataclasses.dataclass(frozen=True)
class StyleSmokeConfig:
    # The record's budget: 800 Adam steps at 128^2, style weight 2000.
    steps: int = 800
    size: int = 128
    style_weight: float = 2000.0
    record: str = STYLE_JSON
    tol: float = 0.02         # against the record (a TPU run)
    emx_cpu_tol: float = 0.01  # against emx's run on the inputs' CPU


def phase_style(device: torch.device, cfg: StyleSmokeConfig) -> dict:
    """emx_torch.bench.style_artifact.main on the committed inputs
    (emx's feature parameters and canvas noise): gram_gap_closed and
    content_correlation within `tol` of the record and within
    `emx_cpu_tol` of emx's own run recorded in the inputs file."""
    from emx_torch.bench import style_artifact

    with open(cfg.record) as f:
        rec = json.load(f)
    with np.load(style_artifact.INPUTS) as z:
        emx_cpu = json.loads(bytes(z["meta_json"]).decode())["emx_cpu"]
    before = _launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        got = style_artifact.main(tmp, cfg.size, cfg.steps,
                                  cfg.style_weight, device=device)
        written = sorted(os.listdir(tmp))
    failures = []
    _gate(failures, (rec["steps"], rec["size"], rec["style_weight"])
          == (cfg.steps, cfg.size, cfg.style_weight),
          f"the record ran {rec['steps']} steps at {rec['size']}, weight "
          f"{rec['style_weight']}")
    _gate(failures, written == ["content.tif", "output.tif", "quality.json",
                                "style.tif"], f"wrote {written}")
    for k in ("gram_gap_closed", "content_correlation"):
        port = got[f"{k}_exact"]
        log("style", f"{k}: port {port:.4f}, record {rec[k]} (diff "
            f"{port - rec[k]:+.4f}, gate +-{cfg.tol}), emx on a CPU "
            f"{emx_cpu[k]:.4f} (diff {port - emx_cpu[k]:+.4f}, gate "
            f"+-{cfg.emx_cpu_tol})")
        _gate(failures, abs(port - rec[k]) <= cfg.tol,
              f"{k} {port:.4f} against the record's {rec[k]}")
        _gate(failures, abs(port - emx_cpu[k]) <= cfg.emx_cpu_tol,
              f"{k} {port:.4f} against emx's CPU run {emx_cpu[k]:.4f}")
    _gate(failures, got["ok"], "the artifact's own ok is false")
    after = _launch_counts()
    _gate(failures, after == before, "K1/K2 launched")
    got["launches"] = (after[0] - before[0], after[1] - before[1])
    if got["seconds"] is not None:
        log("style", f"{cfg.steps} Adam steps in {got['seconds']:.2f} s "
            f"({cfg.steps / got['seconds']:.1f} steps/s) on "
            f"{card_name_and_power()}")
    if failures:
        raise AssertionError("style: " + "; ".join(failures))
    return got


DQN_POLICY = "docs/runs/dqn_autofocus_v2/policy.npz"
DQN_RECORD = "docs/runs/dqn_autofocus_v2/quality.json"
DQN_TRACE = "docs/runs/port_dqn_eval/emx_trace.json"
DQN_NUDGED = "docs/runs/port_dqn_eval/emx_nudged_rows.json"
# Each serial row's metrics: the tolerances fixed before the first card
# run, around the span of emx's own runs (the record's and 200 with the
# propagation changed in its last bits; PERF.md §6).
DQN_ROW_TOL = {"solve_rate": 0.04, "true_solve_rate": 0.04,
               "mean_steps": 0.3, "mean_return": 0.5,
               "mean_final_distance": 0.25, "mean_final_true_distance": 0.25}
# The random row's metrics that no frame moves: its shifts are its own
# numpy draws, and its distance to the scan's target is the start's
# offset (the env's draw after the dqn row's 50 resets) plus the shifts.
# Equal to the record's.
DQN_FRAME_FREE = ("solve_rate", "mean_steps", "mean_return",
                  "mean_final_distance")
# The record's true-target comparisons, each true there.
DQN_BEATS = ("beats_random_true_distance", "beats_hillclimb_true_distance",
             "beats_random_gt", "beats_hillclimb_gt")


@dataclasses.dataclass(frozen=True)
class ScopeSmokeConfig:
    # The committed policy's evaluation uncut: 50 episodes a serial row
    # (the record's), the vec greedy evaluation at 128 lanes.
    n_eval: int = 50
    vec_solve_min: float = 0.95     # record 1.0
    vec_dist_max: float = 0.10      # record 0.072
    gt_solve_tol: float = 0.2       # dqn_true_target's solve rate, 0.64
    # The noiseless frames on the card against the CPU's at 6 planes off
    # focus (the Q values are held to dqn_vec.Q_TOL).
    frame_tol: float = 2e-5
    # The vec trainer at dqn_vec's configuration, cut to train_iters
    # iterations of vec_batch lanes (the first 5000 transitions fill the
    # buffer); profile_iters more under the profiler.
    vec_batch: int = 128
    train_iters: int = 300
    train_warmup: int = 5000
    profile_iters: int = 4
    # `dqn-autofocus` through the CLI: the serial trainer cut to a few
    # episodes, then its 50-episode evaluation.
    cli_episodes: int = 3
    # emx's tests/test_aux.py recipe: 24 frames a class at 32^2, 300 steps.
    classifier_per_class: int = 24
    classifier_size: int = 32
    classifier_steps: int = 300


def dqn_rows_against_record(rows: dict, record: dict,
                            nudged: list[dict]) -> list[dict]:
    """Each serial row's metric beside the span of emx's runs (`record`
    and the `nudged` rows), and whether it lies within DQN_ROW_TOL of
    that span."""
    out = []
    for row, metrics in record.items():
        for k, tol in DQN_ROW_TOL.items():
            if k in metrics:
                emx = [metrics[k], *(n[row][k] for n in nudged)]
                port = rows[row][k]
                out.append({"row": row, "metric": k, "port": port,
                            "record": metrics[k],
                            "emx": [min(emx), max(emx)],
                            "within": min(emx) - tol - 1e-9 <= port
                            <= max(emx) + tol + 1e-9})
    return out


def q_against_reference(trace: dict) -> dict:
    """The DQN rows' Q values (the port's module, as the policy read
    them) against dqn.reference_q_values on the same observations: the
    largest difference, and the greedy actions that differ where the
    reference's two best values are more than 2 dqn_vec.Q_TOL apart."""
    from emx_torch.bench.dqn_vec import Q_TOL
    from emx_torch.scope.dqn import flat_flax_params, reference_q_values

    steps = [(q, o) for row in ("dqn", "dqn_true_target")
             for ep in trace[row] for q, o in zip(ep["q"], ep["obs"])]
    q = np.array([s[0] for s in steps])
    ref = reference_q_values(flat_flax_params(DQN_POLICY),
                             np.stack([s[1] for s in steps]))
    top = np.sort(ref, 1)
    flips = (q.argmax(1) != ref.argmax(1)) & (top[:, -1] - top[:, -2]
                                             > 2 * Q_TOL)
    return {"steps": len(steps), "max_diff": float(np.abs(q - ref).max()),
            "flips": int(flips.sum())}


def frames_against_cpu(device: torch.device) -> float:
    """The simulator's noiseless frames (make_env's microscope, dose 0)
    on `device` against the CPU's on both sides of focus: the largest
    difference of the [0, 1] frames. Not at focus: a pure phase object
    is flat there, and the rescale to [0, 1] magnifies the last bits."""
    from emx_torch.scope.sim import SimulatedMicroscope

    scopes = [SimulatedMicroscope(image_size=48, dose=0, seed=123,
                                  device=d) for d in (device, "cpu")]
    worst = 0.0
    for z in (-3.0, -1.5, -0.75, 0.75, 1.5, 3.0):
        for sc in scopes:
            sc.z = float(z)
        a, b = (sc.acquire() for sc in scopes)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def scope_eval(device: torch.device, cfg: ScopeSmokeConfig,
               failures: list) -> dict:
    """dqn_vec.main on the committed policy, the six serial rows traced:
    every DQN step's Q values against the float64 forward; the noiseless
    frames against the CPU's; each row against emx's trace while the
    frames agree (no fault); each row's metrics against the span of
    emx's runs; the random row's frame-free metrics, the record's
    true-target comparisons and dqn_true_target's solve rate against
    the record; the vec greedy evaluation."""
    from emx_torch.bench import dqn_vec

    with open(DQN_RECORD) as f:
        record = json.load(f)
    with open(DQN_TRACE) as f:
        ref = {k: v[:cfg.n_eval] for k, v in json.load(f).items()}
    trace: dict = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got = dqn_vec.main(tmp, 0, cfg.vec_batch, device=device,
                           policy_npz=DQN_POLICY, trace=trace,
                           n_eval=cfg.n_eval)
        with open(os.path.join(tmp, "quality.json")) as f:
            rows = json.load(f)["results"]
    seconds = time.perf_counter() - t0
    q = q_against_reference(trace)
    log("scope", f"Q values of {q['steps']} DQN steps against the float64 "
        f"forward: largest difference {q['max_diff']:.3g}, {q['flips']} "
        "greedy actions off it")
    _gate(failures, q["max_diff"] <= dqn_vec.Q_TOL and q["flips"] == 0,
          f"Q values against the float64 forward: {q}")
    frames = frames_against_cpu(device)
    log("scope", f"noiseless frames against the CPU's: largest difference "
        f"{frames:.3g}")
    _gate(failures, frames <= cfg.frame_tol,
          f"noiseless frames {frames:.3g} off the CPU's")
    compared = dqn_vec.compare_traces(trace, ref)
    for row, c in compared.items():
        log("scope", f"{row}: {json.dumps(rows[row])}; against emx's trace "
            f"{json.dumps(c)}")
        _gate(failures, c["fault"] is None,
              f"{row} leaves emx's trace on the same frames: {c}")
    table = []
    if cfg.n_eval == record["eval_episodes"]:
        with open(DQN_NUDGED) as f:
            nudged = list(json.load(f)["rows"].values())
        table = dqn_rows_against_record(rows, record["results"], nudged)
        outside = [t for t in table if not t["within"]]
        log("scope", f"rows against emx's {1 + len(nudged)} runs: "
            f"{len(table) - len(outside)} of {len(table)} metrics within "
            "the tolerances of their span")
        _gate(failures, not outside,
              f"row metrics outside emx's span: {json.dumps(outside)}")
        rec_random = record["results"]["random"]
        for k in DQN_FRAME_FREE:
            _gate(failures, rows["random"][k] == rec_random[k],
                  f"random row {k} {rows['random'][k]} where the record "
                  f"has {rec_random[k]}")
        for k in DQN_BEATS:
            _gate(failures, got[k] == record[k],
                  f"{k} {got[k]} where the record has {record[k]}")
        gt = rows["dqn_true_target"]["solve_rate"]
        _gate(failures, abs(gt - record["gt_solve_rate"]) <= cfg.gt_solve_tol,
              f"dqn_true_target solve rate {gt} against the record's "
              f"{record['gt_solve_rate']} +-{cfg.gt_solve_tol}")
    vec = got["vec_greedy_eval"]
    log("scope", f"vec greedy evaluation {json.dumps(vec)} (record "
        f"{json.dumps(record['vec_greedy_eval'])}); evaluation "
        f"{seconds:.1f} s")
    _gate(failures, vec["solve_rate"] >= cfg.vec_solve_min
          and vec["mean_final_distance"] <= cfg.vec_dist_max,
          f"vec greedy evaluation {vec}")
    return {"rows": rows, "compared": compared, "table": table, "q": q,
            "frames_max_diff": frames, "vec_greedy_eval": vec,
            "seconds": seconds}


def scope_train(device: torch.device, cfg: ScopeSmokeConfig,
                failures: list) -> dict:
    """The vec trainer for train_iters iterations: env steps/s over the
    run, gradient steps/s after the warm-up, finite losses; on the card a
    profiled window of iterations: device busy ms, idle share, kernels an
    iteration."""
    from emx_torch.bench import dqn_vec

    env, agent = dqn_vec.make_trainer(cfg.train_iters * cfg.vec_batch,
                                      cfg.vec_batch, device,
                                      warmup=cfg.train_warmup)
    state, obs = env.reset(seed=0)
    losses = []
    _sync(device)
    t0 = time.perf_counter()
    t_first_grad = steps_before = None
    for _ in range(cfg.train_iters):
        state, obs, done, info, loss = dqn_vec.train_iteration(
            env, agent, state, obs)
        losses.append(loss)
        if t_first_grad is None and agent.train_count:
            _sync(device)
            t_first_grad, steps_before = time.perf_counter(), \
                agent.train_count
    _sync(device)
    t1 = time.perf_counter()
    out = {"env_steps": agent.step_count, "gradient_steps": agent.train_count,
           "seconds": t1 - t0, "env_steps_per_s": agent.step_count / (t1 - t0)}
    if t_first_grad is not None and agent.train_count > steps_before:
        out["gradient_steps_per_s"] = ((agent.train_count - steps_before)
                                       / (t1 - t_first_grad))
    trained = [v for v in losses if v is not None]
    _gate(failures, trained and all(np.isfinite(trained)),
          f"vec training losses {trained[:3]}...{trained[-3:]}")
    _gate(failures, agent.train_count == 2 * len(trained),
          f"{agent.train_count} gradient steps for {len(trained)} iterations")
    if device.type == "cuda":
        from emx_torch.bench.forward_profile import profile_forward

        box = {"state": state, "obs": obs}

        def step(_unused):
            box["state"], box["obs"], *rest = dqn_vec.train_iteration(
                env, agent, box["state"], box["obs"])

        prof = profile_forward(step, None, n=cfg.profile_iters)
        out.update(idle_share=prof["idle_share"],
                   device_busy_ms=prof["device_busy_ms"],
                   iteration_ms=prof["wall_ms"],
                   kernels_per_iteration=prof["kernels_per_forward"],
                   top_kernels_ms=prof["top_kernels_ms"][:5])
    rate = (f"{out['env_steps_per_s']:.1f} env steps/s, "
            f"{out.get('gradient_steps_per_s', float('nan')):.1f} gradient "
            f"steps/s after the warm-up" if device.type == "cuda"
            else "no rate (CPU)")
    log("scope", f"vec training: {cfg.train_iters} iterations of "
        f"{cfg.vec_batch} lanes, {agent.step_count} env steps, "
        f"{agent.train_count} gradient steps (batch 256), last loss "
        f"{trained[-1] if trained else None}; {rate}" + (
            f"; profiled {cfg.profile_iters} iterations: "
            f"{out['iteration_ms']:.2f} ms wall, {out['device_busy_ms']:.2f}"
            f" ms device busy, idle {out['idle_share']:.3f}, "
            f"{out['kernels_per_iteration']:.0f} kernels; top "
            f"{out['top_kernels_ms']}" if "idle_share" in out else ""))
    return out


def phase_scope(device: torch.device, cfg: ScopeSmokeConfig) -> dict:
    """The live-microscope path: the committed policy's evaluation
    (scope_eval), the vec trainer (scope_train), `dqn-autofocus` through
    the CLI, and the fringe classifier on the simulator's labels. No K1
    or K2 launch: the simulator propagates with cuFFT, the vec env draws
    with torch.poisson (emx's exact jax.random.poisson), the networks
    are cuDNN's."""
    from emx_torch.scope.classifier import (collect_fringe_dataset,
                                            train_fringe_classifier)
    from emx_torch.scope.sim import SimulatedMicroscope

    before = _launch_counts()
    failures: list = []
    t0 = time.perf_counter()
    evaluated = scope_eval(device, cfg, failures)
    trained = scope_train(device, cfg, failures)
    # In this process (the CLI's entry point; a subprocess would add the
    # ~10 s of a fresh interpreter and CUDA context to the run).
    from emx_torch import cli as cli_module

    out = io.StringIO()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(out):
        cli_module.main(["dqn-autofocus", tmp, str(cfg.cli_episodes),
                         f"--device={device.type}"])
    cli = json.loads(out.getvalue().splitlines()[-1])
    _gate(failures, cli["train_episodes"] == cfg.cli_episodes
          and cli["eval_episodes"] == 50
          and all(np.isfinite(v) for k, v in cli.items()
                  if k.startswith("dqn_") and isinstance(v, float)),
          f"dqn-autofocus summary {cli}")
    log("scope", f"dqn-autofocus ({cfg.cli_episodes} episodes) in "
        f"{time.perf_counter() - t1:.1f} s: {json.dumps(cli)}")
    scope = SimulatedMicroscope(image_size=cfg.classifier_size, dose=0,
                                optimal_z=0.0, device=device)
    x, y = collect_fringe_dataset(scope, cfg.classifier_per_class, seed=0)
    t1 = time.perf_counter()
    res = train_fringe_classifier(x, y, steps=cfg.classifier_steps, seed=0,
                                  device=device)
    fit_s = time.perf_counter() - t1
    _gate(failures, res.accuracy > 0.8 and res.losses[-1] < res.losses[0],
          f"fringe classifier accuracy {res.accuracy}, loss "
          f"{res.losses[0]} -> {res.losses[-1]}")
    log("scope", f"fringe classifier: {len(y)} frames, "
        f"{cfg.classifier_steps} steps in {fit_s:.2f} s, loss "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}, accuracy "
        f"{res.accuracy:.3f}")
    after = _launch_counts()
    _gate(failures, after == before,
          f"K1/K2 launches moved {before} -> {after}")
    card = f" on {card_name_and_power()}" if device.type == "cuda" else ""
    log("scope", f"phase {time.perf_counter() - t0:.1f} s{card}; K1/K2 "
        f"launches in the phase: {after[0] - before[0]}/"
        f"{after[1] - before[1]}")
    if failures:
        raise AssertionError("scope: " + "; ".join(failures))
    return {"eval": evaluated, "train": trained, "cli": cli,
            "classifier_accuracy": res.accuracy,
            "launches": (after[0] - before[0], after[1] - before[1])}


@dataclasses.dataclass(frozen=True)
class SweepSmokeConfig:
    # emx_torch.bench.sweep's base16 (bf16 group-norm Denoiser, batch 16
    # of 512x512) for a few launches; `scale` < 1 narrows it (CPU).
    variant: str = "base16"
    n_iters: int = 5
    size: int = 512
    batch: int | None = None
    scale: float = 1.0


def phase_sweep(device: torch.device, cfg: SweepSmokeConfig) -> dict:
    """sweep.measure on one variant: img/s and ms a launch (one
    synchronise after the last launch), finite forwards; no K1 or K2
    launch (the group-norm Denoiser's blocks normalise before their
    activation, which K1 does not fuse)."""
    from emx_torch.bench import sweep

    model_cfg, batch = sweep.variants()[cfg.variant]
    if cfg.scale != 1.0:
        model_cfg = model_cfg.scaled(cfg.scale)
    before = _launch_counts()
    out = sweep.measure(cfg.variant, model_cfg, cfg.batch or batch,
                        cfg.n_iters, cfg.size, device)
    after = _launch_counts()
    failures: list = []
    _gate(failures, after == before, f"K1/K2 launches moved {before} -> "
          f"{after}")
    _gate(failures, out["img_per_s"] > 0, f"sweep {out}")
    log("sweep", f"{json.dumps(out)}" + ("" if device.type == "cuda"
                                         else " (CPU: not a card rate)"))
    if failures:
        raise AssertionError("sweep: " + "; ".join(failures))
    out["launches"] = (after[0] - before[0], after[1] - before[1])
    return out


@dataclasses.dataclass(frozen=True)
class ParallelSmokeConfig:
    """emx_torch.parallel at world size 1 over a real process group: the
    data-parallel trainer at the graph phase's flagship config, K2's image
    offset, halo serving of one big micrograph and the dry run."""
    model: DenoiserConfig = FLAGSHIP_TRAIN
    n_images: int = 32
    size: int = 512
    batch: int = 16
    steps: int = 6
    k: int = 8
    learning_rate: float = 1e-3
    seed: int = 0
    pre_steps: int = 1
    # K2 launches per train step (0 where no kernel runs).
    k2_per_step: int = 1
    # K2's image offsets checked at the training batch.
    offsets: tuple[int, ...] = (3, 8)
    bundle: str = SmokeConfig.bundle
    fused_rows: int = 32
    big: int = 4096          # the int8 graph's micrograph side
    float_big: int = 2048    # the float Denoiser's
    dose: float = 100.0      # a training dose (25 + 75 Exp(1) has mean 100)
    tile: int = 512
    overlap: int = 80
    tile_batch: int = 8
    # Least K1 launches per forward of the fused graph (0 where none
    # runs): the six body-resolution blocks; on a big image the encoder's
    # blocks qualify too (emx's min_pixels 16384).
    min_launches_per_forward: int = K1_PER_FORWARD


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _halo_rule(name: str, out, tiled, full, failures: list) -> dict:
    """emx's rule (tests/test_parallel_ops.py:161-164): the halo-parallel
    output's mean error against the full-image pass at most twice the
    tiled one's, or 5e-3."""
    err_halo = float((out - full).abs().mean())
    err_tiled = float((tiled - full).abs().mean())
    _gate(failures, out.shape == full.shape
          and bool(torch.isfinite(out).all()), f"{name}: shape "
          f"{tuple(out.shape)} or non-finite output")
    _gate(failures, err_halo <= max(2 * err_tiled, 5e-3),
          f"{name}: halo error {err_halo:.3e} against tiled {err_tiled:.3e}")
    return {"err_halo": err_halo, "err_tiled": err_tiled}


@contextlib.contextmanager
def k1_checked(checks: list):
    """Inside the block the fused graph's fused_sepconv launches the
    kernel and holds it against its plain version on the same inputs
    (phase_kernel's tolerance), appending one record per call to
    `checks`."""
    import emx_torch.serve.fused as fused_mod

    real = fused_mod.fused_sepconv

    def checking(x, dw, dwb, pw, pwb, rows=32):
        got = real(x, dw, dwb, pw, pwb, rows=rows)
        ref = sepconv_reference(x, dw, dwb, pw, pwb)
        g, r = got.float(), ref.float()
        err = (g - r).abs()
        b, h, w, c = x.shape
        checks.append({
            "name": f"halo{len(checks)}", "shape": [b, h, w, c, pwb.numel()],
            "max_abs_err": float(err.max()),
            "ok": bool((err <= 2 ** -7 * r.abs() + 1e-3).all())
            and bool(torch.isfinite(g).all())})
        return got

    fused_mod.fused_sepconv = checking
    try:
        yield checks
    finally:
        fused_mod.fused_sepconv = real


def one_rank_reference(apply_fn, img: torch.Tensor, halo: int,
                       grid: int) -> torch.Tensor:
    """What spatial_apply computes on one rank: the image padded to the
    grid (reflected with the edge row), then by `halo` rows reflected
    without the edge row at each end, in one pass, cropped."""
    h = img.shape[0]
    pad = -(-h // grid) * grid - h
    x = torch.cat([img, img[h - pad:].flip(0)]) if pad else img
    x = torch.cat([x[1:halo + 1].flip(0), x, x[-halo - 1:-1].flip(0)])
    return apply_fn(x)[halo:halo + h]


def _one_rank_gate(name: str, out, ref, failures: list) -> float:
    diff = float((out - ref).abs().max())
    _gate(failures, diff <= BF16_STEP, f"{name}: spatial_apply departs "
          f"from the one-rank reference by {diff:.3e}")
    return diff


def parallel_train(device: torch.device, cfg: ParallelSmokeConfig,
                   mesh, failures: list) -> dict:
    """From one state, `steps` eager steps without a mesh and under the
    one-rank mesh (every loss and the whole state equal), then under the
    mesh one replay of a CUDA graph of `k` steps against `k` eager steps
    (equal); cudnn deterministic. Returns the K2 launches of the meshed
    steps and replay, and both step times."""
    was = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        corpus = synthetic_micrographs(cfg.n_images, cfg.size, seed=cfg.seed)
        model = Denoiser(cfg.model, device=device)
        tcfg = TrainConfig(learning_rate=cfg.learning_rate,
                           optimizer="nesterov", log_every=0, seed=cfg.seed)
        plain = Trainer(model, tcfg, example_fn=denoiser_example)
        meshed = Trainer(model, tcfg, mesh=mesh, example_fn=denoiser_example)
        graphed = Trainer(model, dataclasses.replace(
            tcfg, steps_per_launch=cfg.k), mesh=mesh,
            example_fn=denoiser_example)
        state = plain.init()
        data = DeviceDataset(corpus, PipelineConfig(
            batch_size=cfg.batch, crop_size=cfg.size, seed=cfg.seed),
            device=device)
        plain.fit(state, data, cfg.pre_steps)
        start = _clone_state(model, state.optimizer)
        cursor, step0 = data.state_dict(), state.step

        def rewind():
            _restore_in_place(model, state.optimizer, start)
            state.step = step0
            data.load_state_dict(cursor)
            return iter(data)

        def eager(trainer, n):
            it = rewind()
            _sync(device)
            t0 = time.perf_counter()
            losses = [trainer.step_fn(state, next(it))[1]["loss"]
                      for _ in range(n)]
            _sync(device)
            ms = 1e3 * (time.perf_counter() - t0) / n
            return (torch.stack(losses).tolist(),
                    _clone_state(model, state.optimizer), ms)

        eager(meshed, 1)   # the collectives' first use, not timed
        loss_a, after_a, ms_a = eager(plain, cfg.steps)
        k2 = degrade_kernel.fused_poisson_degrade.launches
        loss_b, after_b, ms_b = eager(meshed, cfg.steps)
        k2 = degrade_kernel.fused_poisson_degrade.launches - k2
        mesh_diff = max(max(abs(a - b) for a, b in zip(loss_a, loss_b)),
                        _max_state_diff(after_a, after_b))
        loss_e, after_e, _ = eager(meshed, cfg.k)
        it = rewind()
        metrics = graphed._launch(state, [next(it) for _ in range(cfg.k)])
        _sync(device)
        loss_g = metrics[:, 0].tolist()
        graph_diff = max(max(abs(a - b) for a, b in zip(loss_e, loss_g)),
                         _max_state_diff(after_e, _clone_state(
                             model, state.optimizer)))
        per_replay = graphed.graph.k2_per_replay
        log("parallel", f"{cfg.steps} eager steps of batch {cfg.batch} at "
            f"{cfg.size}x{cfg.size} under the one-rank mesh against none: "
            f"max |loss or state difference| {mesh_diff:.3e} (must be 0); "
            f"{ms_b:.2f} ms a step under the mesh, {ms_a:.2f} ms without; "
            f"K2 launches {k2} (expected {cfg.k2_per_step * cfg.steps})")
        log("parallel", f"under the mesh, one replay of {cfg.k} steps "
            f"against {cfg.k} eager steps: max |loss or state difference| "
            f"{graph_diff:.3e} (must be 0); K2 launches per replay "
            f"{per_replay}; capture {graphed.graph_stats['capture_s']:.2f} s")
        _gate(failures, mesh_diff == 0.0, f"the mesh departs from no mesh: "
              f"{mesh_diff}")
        _gate(failures, graph_diff == 0.0, f"the graph under the mesh "
              f"departs from eager: {graph_diff}")
        _gate(failures, k2 == cfg.k2_per_step * cfg.steps,
              f"K2 launched {k2} times in {cfg.steps} meshed steps")
        _gate(failures, per_replay == cfg.k2_per_step * cfg.k,
              f"K2 launched {per_replay} times in a graph of {cfg.k} steps")
        return {"mesh_diff": mesh_diff, "graph_diff": graph_diff,
                "step_ms_mesh": ms_b, "step_ms_plain": ms_a,
                "launches": k2 + per_replay}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was


def parallel_offsets(device: torch.device, cfg: ParallelSmokeConfig,
                     failures: list) -> dict:
    """K2 at the training batch with `image_offset=k` on rows [k:]: equal
    on every element to rows [k:] of the whole batch's launch and to the
    plain version, eagerly and (on the card) in a captured graph."""
    rng = np.random.default_rng(3)
    imgs_np, scales_np = training_batch(rng, cfg.batch, cfg.size)
    imgs = torch.from_numpy(imgs_np).to(device)
    scales = torch.from_numpy(scales_np).to(device)
    seed = 21
    whole = fused_poisson_degrade(seed, imgs, scales)
    worst = 0.0
    for k in cfg.offsets:
        rows, sc = imgs[k:].contiguous(), scales[k:].contiguous()
        got = fused_poisson_degrade(seed, rows, sc, image_offset=k)
        ref = poisson_degrade_reference(seed, rows, sc, k)
        diffs = [float((got - whole[k:]).abs().max()),
                 float((got - ref).abs().max())]
        if device.type == "cuda":
            key = degrade_kernel.seed_tensor(seed + 1, device)
            fused_poisson_degrade(key, rows, sc, image_offset=k)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                cap = fused_poisson_degrade(key, rows, sc, image_offset=k)
            key.copy_(degrade_kernel.seed_tensor(seed, device))
            graph.replay()
            torch.cuda.synchronize()
            diffs.append(float((cap - ref).abs().max()))
        worst = max(worst, *diffs)
        log("parallel", f"K2 at image offset {k} on rows [{k}:] of "
            f"{tuple(imgs.shape)}: max |difference| against the whole "
            f"launch's rows, the plain version"
            + (" and a captured replay" if device.type == "cuda" else "")
            + f": {', '.join(f'{d:.3e}' for d in diffs)} (must be 0)")
        _gate(failures, max(diffs) == 0.0, f"K2 at offset {k} departs: "
              f"{diffs}")
    return {"max_abs_err": worst}


def parallel_halo(device: torch.device, cfg: ParallelSmokeConfig, mesh,
                  failures: list) -> dict:
    """One big micrograph through spatial_apply with the bundle's K1-fused
    int8 graph on the spatial mesh, against tiled_apply (512 tiles, 80
    overlap) and the full-image pass of the same graph; K1 held at the
    shapes that pass gives it; then halo_denoise of the bundle's float
    Denoiser at float_big."""
    from emx_torch.parallel.halo import halo_denoise, spatial_apply
    from emx_torch.serve.tiling import TiledApplier, tiled_apply

    rng = np.random.default_rng(11)
    noisy, _ = degrade(rng, smooth_field(rng, cfg.big, cfg.big), cfg.dose)
    img = torch.from_numpy(noisy).to(device)
    graph, _ = bundle_graph(cfg.bundle, device, fused_rows=cfg.fused_rows)
    mcfg = read_artifact(cfg.bundle)[0]
    grid = mcfg.halo_grid()
    halo = -(-max(cfg.overlap, grid) // grid) * grid

    def apply_fn(x):
        return graph(x[None].float())[0].float()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    k1 = fused_sepconv.launches
    out = spatial_apply(apply_fn, img, mesh, halo=halo, grid=grid)
    _sync(device)
    k1 = fused_sepconv.launches - k1
    halo_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else 0.0)
    tiled = tiled_apply(lambda x: graph(x.float()).float(), img, cfg.tile,
                        cfg.overlap, cfg.tile_batch)
    full = apply_fn(img)
    # The one-rank reference takes the halo forward's shapes: K1 is held
    # against its plain version on each block's own input there.
    with k1_checked([]) as k1_checks:
        one = one_rank_reference(apply_fn, img, halo, grid)
    _sync(device)
    res = _halo_rule("int8 graph", out, tiled, full, failures)
    res["one_rank_diff"] = _one_rank_gate("int8 graph", out, one, failures)
    expected = len(k1_checks) if device.type == "cuda" else 0
    log("parallel", f"spatial_apply of the K1-fused int8 graph on one "
        f"{cfg.big}x{cfg.big} micrograph (dose {cfg.dose}), halo {halo} "
        f"(grid {grid}): {halo_s:.2f} s, peak {peak:.2f} GiB; mean |error| "
        f"against the full-image pass {res['err_halo']:.3e}, tiled "
        f"({cfg.tile}/{cfg.overlap}) {res['err_tiled']:.3e}; max |difference|"
        f" from the one-rank reference {res['one_rank_diff']:.3e} (tolerance "
        f"{BF16_STEP}); K1 launches {k1} (expected {expected}, at least "
        f"{cfg.min_launches_per_forward})")
    log("parallel", f"K1 against its plain version on the halo forward's "
        f"own block inputs: " + ", ".join(
            f"{c['shape']} {c['max_abs_err']:.3e}" for c in k1_checks)
        + " (tol 2^-7|r|+1e-3)")
    _gate(failures, k1 == expected and k1 >= cfg.min_launches_per_forward,
          f"K1 launched {k1} times in one halo forward")
    _gate(failures, all(c["ok"] for c in k1_checks), "K1 disagrees with its "
          "plain version in the halo forward")
    del out, tiled, full, one

    model = load_flax_params(Denoiser(mcfg, device="cpu"),
                             read_artifact(cfg.bundle)[1])
    model = model.to(device).eval().requires_grad_(False)
    fimg = img[:cfg.float_big, :cfg.float_big].contiguous()
    t0 = time.perf_counter()
    fout = halo_denoise(model, fimg, mesh)
    _sync(device)
    float_s = time.perf_counter() - t0
    with torch.inference_mode():
        ftiled = TiledApplier(model, cfg.tile, cfg.overlap, cfg.tile_batch,
                              preprocess=False)(fimg)
        ffull = model(fimg[None])[0].float()
        fone = one_rank_reference(lambda x: model(x[None])[0].float(), fimg,
                                  -(-max(80, grid) // grid) * grid, grid)
    fres = _halo_rule("float Denoiser", fout.float(), ftiled.float(), ffull,
                      failures)
    fres["one_rank_diff"] = _one_rank_gate("float Denoiser", fout.float(),
                                           fone, failures)
    log("parallel", f"halo_denoise of the bundle's float Denoiser on "
        f"{cfg.float_big}x{cfg.float_big}: {float_s:.2f} s; mean |error| "
        f"against the full-image pass {fres['err_halo']:.3e}, tiled "
        f"{fres['err_tiled']:.3e}; max |difference| from the one-rank "
        f"reference {fres['one_rank_diff']:.3e}")
    return {"int8": res, "float": fres, "launches": k1, "halo_s": halo_s,
            "float_s": float_s, "peak_gib": peak, "k1_checks": k1_checks}


def phase_parallel(device: torch.device, cfg: ParallelSmokeConfig) -> dict:
    """emx_torch.parallel on one card: initialize() over a one-rank group
    (NCCL on the card, gloo on the CPU) and one all-reduce; the
    data-parallel trainer under make_mesh_for_batch (parallel_train);
    K2's offset (parallel_offsets); halo serving (parallel_halo); and
    dryrun_multichip. Every gate is collected; the phase raises at its
    end if one failed, and leaves the group either way."""
    import torch.distributed as dist

    from emx_torch.parallel import make_mesh, make_mesh_for_batch
    from emx_torch.parallel.distributed import initialize
    from emx_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    backend = "nccl" if device.type == "cuda" else "gloo"
    initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend=backend)
    failures: list = []
    try:
        x = torch.arange(4.0, device=device)
        dist.all_reduce(x)
        _sync(device)
        log("parallel", f"process group: backend {dist.get_backend()}, "
            f"world {dist.get_world_size()}, all_reduce {x.tolist()}")
        _gate(failures, dist.get_backend() == backend
              and dist.get_world_size() == 1
              and x.tolist() == [0.0, 1.0, 2.0, 3.0],
              f"process group {dist.get_backend()}, {x.tolist()}")
        mesh = make_mesh_for_batch(cfg.batch, device=device)
        parts = {"setup": time.perf_counter() - t0}

        def timed(name, fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            parts[name] = time.perf_counter() - t
            return out

        trained = timed("train", parallel_train, device, cfg, mesh, failures)
        offsets = timed("offsets", parallel_offsets, device, cfg, failures)
        served = timed("halo", parallel_halo, device, cfg, make_mesh(
            data=1, spatial=1, device=device), failures)
        # As this rank of the one-rank group.
        dry = timed("dryrun", dryrun_multichip, 1)
        log("parallel", f"dryrun_multichip(1): {dry}")
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    log("parallel", f"{seconds:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) + ")"
        + (f" on {card_name_and_power()}" if device.type == "cuda" else ""))
    if failures:
        raise AssertionError("parallel: " + "; ".join(failures))
    return {"train": trained, "offsets": offsets, "halo": served,
            "dryrun": dry, "seconds": seconds,
            "launches": (served["launches"], trained["launches"])}


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
    graphed = phase_graph(device, GraphSmokeConfig())
    files = phase_files(device, FilesSmokeConfig())
    quality = phase_quality(device, QualitySmokeConfig())
    decided = phase_decision(device, DecisionSmokeConfig())
    phase_variants(device, DecisionSmokeConfig())
    auto = phase_auto(device, AutoSmokeConfig())
    phase_export(device, ExportSmokeConfig())
    qat = phase_qat(device, QatSmokeConfig())
    phase_gan(device, GanSmokeConfig())
    phase_gan_quality(device, GanQualitySmokeConfig())
    phase_gan_demo(device, GanDemoSmokeConfig())
    phase_ewrec(device, EwrecSmokeConfig())
    zoo = phase_zoo(device, ZooSmokeConfig())
    style = phase_style(device, StyleSmokeConfig())
    scope = phase_scope(device, ScopeSmokeConfig())
    swept = phase_sweep(device, SweepSmokeConfig())
    parallel = phase_parallel(device, ParallelSmokeConfig())
    kernel_results = kernel_results + parallel["halo"]["k1_checks"]
    degraded["max_abs_err"] = max(degraded["max_abs_err"],
                                  parallel["offsets"]["max_abs_err"])
    # The zoo, style, scope and sweep phases reach neither kernel: their
    # entries are the counts read around them (0).
    print(json.dumps(kernels_line(
        kernel_results, served["launches"], degraded, trained_launches,
        {"serve": served["launches"], "deploy": deployed["launches"],
         "decision": decided["launches"], "auto": auto["launches"],
         "qat": qat["k1_launches"], "zoo": zoo["launches"][0],
         "style": style["launches"][0], "scope": scope["launches"][0],
         "sweep": swept["launches"][0],
         "parallel": parallel["launches"][0]},
        {"train": trained_launches, "graph": graphed["launches"],
         "files": files["launches"], "quality": quality["launches"],
         "qat": qat["k2_launches"], "zoo": zoo["launches"][1],
         "style": style["launches"][1], "scope": scope["launches"][1],
         "sweep": swept["launches"][1],
         "parallel": parallel["launches"][1]})), flush=True)
    log("done", f"{time.perf_counter() - t0:.1f} s on {info['smi']}; "
        f"deploy K1 launches {deployed['launches']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root; one card, nvcc

Phases, one line each (a phase that fails raises; the script then exits
non-zero and prints no result):

  1. device  the card's name, the device count, and nvidia-smi's name
             and power limit. No CUDA device: raise.
  2. build   nvcc builds emx_torch/csrc/sepconv.cu; seconds and the
             ptxas register / shared-memory lines.
  3. kernel  K1 (fused_sepconv) against its plain PyTorch version on the
             card, at the six flagship shapes (B=8, 128x128, bf16) and
             two ragged ones; CUDA-event times of the kernel, the plain
             version and the cuDNN depthwise + pointwise pair, and the
             card's least time for the same work.
  4. serve   emx_torch.serve.server.serve_artifact on the flagship int8
             bundle with fused_rows=32: 512x512 requests and one
             1024x768 (tiled) request over HTTP. Checks shape, finite
             [0, 1] outputs, six K1 launches per 512x512 forward,
             denoised PSNR above noisy PSNR, and the fused graph against
             the unfused int8 graph; times the forward at batch 1 and 8.
  5. the kernels line (JSON), then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Inputs are made from fixed seeds with numpy. The phases are functions of
(device, config), so the CPU tests rehearse the ones that need no
kernel on a tiny bundle.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from emx_torch.ops import _build
from emx_torch.ops.sepconv_kernel import fused_sepconv, sepconv_reference
from emx_torch.serve.artifact import load_denoiser_artifact
from emx_torch.serve.fused import fused_quantized_apply, row_band
from emx_torch.serve.quantize import quantized_apply
from emx_torch.serve.server import serve_artifact
from emx_torch.serve.tiling import _origins
from emx_torch.utils.device import card_name_and_power
from emx_torch.utils.image import psnr, scale0to1

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
FLAGSHIP_SHAPES = (
    ("enc0.a", 8, 128, 128, 16, 64), ("enc0.b", 8, 128, 128, 64, 64),
    ("refine.a", 8, 128, 128, 128, 64), ("refine.b", 8, 128, 128, 64, 64),
    ("folded.a", 8, 128, 128, 80, 128), ("folded.b", 8, 128, 128, 128, 128),
)
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


def phase_build() -> dict:
    built = _build.load("sepconv")
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log("build", f"nvcc {built.seconds:.2f} s -> {built.path.name}")
    for ln in ptxas:
        log("build", ln)
    return {"seconds": built.seconds, "ptxas": ptxas}


def _sepconv_inputs(rng, b, h, w, c, co, device):
    x = torch.from_numpy(rng.uniform(0.0, 6.0, (b, h, w, c)).astype(
        np.float32)).to(device, torch.bfloat16)
    dw = torch.from_numpy(rng.normal(0, 0.3, (3, 3, 1, c)).astype(np.float32))
    dwb = torch.from_numpy(rng.normal(0, 0.1, (c,)).astype(np.float32))
    pw = torch.from_numpy(rng.normal(0, 1 / math.sqrt(c), (1, 1, c, co))
                          .astype(np.float32))
    pwb = torch.from_numpy(rng.normal(0, 0.1, (co,)).astype(np.float32))
    return x, *(t.to(device) for t in (dw, dwb, pw, pwb))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of `fn` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sepconv_bound_ms(b, h, w, c, co) -> tuple[float, str]:
    """Least time for the card: each input read once, the output written
    once; depthwise operations at the f32 rate, pointwise at bf16."""
    px = b * h * w
    nbytes = px * c * 2 + px * co * 2 + 4 * (9 * c + c + c * co + co)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = px * 18 * c / F32_OPS_PER_S + px * 2 * c * co / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel(device: torch.device,
                 shapes=FLAGSHIP_SHAPES + RAGGED_SHAPES) -> list[dict]:
    """K1 against its plain version on `device`, timed at the flagship
    shapes on the card. Tolerance: one bf16 rounding step of the output,
    |k - r| <= 2^-7 |r| + 1e-3, since the kernel sums the pointwise
    product in another order than the plain version's matmul (its bf16
    depthwise intermediate is bit-identical)."""
    rng = np.random.default_rng(0)
    results = []
    for shape in shapes:
        name, b, h, w, c, co = shape
        x, dw, dwb, pw, pwb = _sepconv_inputs(rng, b, h, w, c, co, device)
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
        if shape in FLAGSHIP_SHAPES and device.type == "cuda":
            xn = x.permute(0, 3, 1, 2)
            w_dw = dw.reshape(3, 3, c).permute(2, 0, 1)[:, None].to(
                torch.bfloat16).contiguous()
            w_pw = pw.reshape(c, co).t()[:, :, None, None].to(
                torch.bfloat16).contiguous()
            b_dw, b_pw = dwb.to(torch.bfloat16), pwb.to(torch.bfloat16)

            def library():
                y = F.conv2d(xn, w_dw, b_dw, padding=1, groups=c)
                return F.conv2d(y, w_pw, b_pw).clamp_(0.0, 6.0)

            res["ms"] = cuda_ms(lambda: fused_sepconv(x, dw, dwb, pw, pwb,
                                                      rows=rows))
            res["plain_ms"] = cuda_ms(
                lambda: sepconv_reference(x, dw, dwb, pw, pwb), iters=5)
            res["library_ms"] = cuda_ms(library)
            res["bound_ms"], res["bound_by"] = sepconv_bound_ms(b, h, w, c, co)
            line += (f"; kernel {res['ms']:.4f} ms, plain "
                     f"{res['plain_ms']:.4f} ms, cuDNN pair "
                     f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f}"
                     f" ms ({res['bound_by']})")
        log("kernel", line)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{name}: max_abs={max_abs}")
        results.append(res)
    return results


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
                ms = cuda_ms(lambda: fn(xb), iters=10, warmup=2)
                key = f"{name}_b{bsz}"
                result["forward_ms"].setdefault(key, []).append(ms)
            log("serve", f"forward at batch {bsz}, ms per {cfg.tile}x"
                f"{cfg.tile} tile: " + ", ".join(
                    f"{k} {[round(v / bsz, 4) for v in vs]}"
                    for k, vs in result["forward_ms"].items()
                    if k.endswith(f"_b{bsz}")) + f" on {card}")
    return result


def kernels_line(kernel_results: list[dict], launches: int) -> dict:
    """The K1 entry: times summed over the six flagship shapes (one B=8
    forward's fused blocks); error over every shape checked."""
    timed = [r for r in kernel_results if "ms" in r]

    def total(key):
        return sum(r[key] for r in timed) if timed else None

    return {"kernels": [{
        "name": "K1 fused_sepconv", "route": "cuda",
        "source": "emx_torch/csrc/sepconv.cu",
        "replaces": "emx/ops/sepconv_kernel.py:71",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_results),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": timed[0]["bound_by"] if timed else "bytes",
        "library_ms": total("library_ms"),
    }]}


def main() -> None:
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    info = phase_device(device)
    phase_build()
    kernel_results = phase_kernel(device)
    served = phase_serve(device, SmokeConfig())
    print(json.dumps(kernels_line(kernel_results, served["launches"])),
          flush=True)
    log("done", f"{time.perf_counter() - t0:.1f} s on {info['smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()

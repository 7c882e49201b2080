"""Where K2's time goes on the card: build variants of
emx_torch/csrc/degrade.cu, hold each to the plain version, time each.

    python scripts/degrade_ablation.py [VARIANT ...]

Each variant is the committed source with one text substitution (the
script asserts that its anchor is there):

  base       the source as committed;
  no_bm      Box-Muller replaced by rate + u (not exact): its share;
  no_philox  Philox4x32-10 replaced by two multiplies (not exact);
  terms2     DRAIN_TERMS 2 in place of 4;
  slice128   DRAIN_SLICE 128 in place of 64;
  wait_grid  the rescale waits on griddepcontrol.wait (the whole counting
             grid) in place of its image's tally;
  profile    base with clock64 stamps at count_kernel's barriers and
             globaltimer stamps at each block's start and end: the
             cycles a block spends in pass 1 (draw, in-place Box-Muller,
             lists), pass 2 (Box-Muller over the list, exp) and pass 3
             (the drain and the reduction), and how many blocks are
             resident over the grid's span.

For the training batch (chip_smoke.training_batch: 16 synthetic
512x512 micrographs, doses 25 + 75 Exponential(1), seed 7) and constant
images of rate 5 and 200 at (16, 512, 512): whether the output equals
poisson_degrade_reference, and the device time of a call, of its
memset and counting kernel alone and of its rescale alone
(kernel_times.device_ms). Prints one JSON line per variant and case,
and ptxas's registers, stack and spills for each build. Builds with
emx_torch/ops/_build.py's nvcc and flags into the gitignored
emx_torch/_build/degrade_ablation/. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from emx_torch.bench.kernel_times import device_ms  # noqa: E402
from emx_torch.data import synthetic_micrographs  # noqa: E402
from emx_torch.ops import _build  # noqa: E402
from emx_torch.ops.degrade_kernel import (poisson_degrade_reference,  # noqa: E402
                                          seed_tensor)

SRC = (_build.CSRC / "degrade.cu").read_text()
OUT = _build.BUILD_DIR / "degrade_ablation"


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise AssertionError(f"anchor not in degrade.cu: {old!r}")
    return src.replace(old, new)


def _profile(src: str) -> str:
    """Stamps at count_kernel's barriers and at each block's ends."""
    lines, k = [], 0
    for ln in src.split("\n"):
        lines.append(ln)
        if ln.strip() == "__syncthreads();" and k < 4:
            lines.append(
                "  if (threadIdx.x == 0) { long long t = clock64(); "
                f"if ({k}) atomicAdd(&prof_cycles[{k}], "
                "(unsigned long long)(t - t_prev)); t_prev = t; }")
            k += 1
        if "atomicAdd(minmax + 2 * (gridDim.x / tiles) + b, 1u);" in ln:
            lines.append("    if (blockIdx.x < 16384) prof_end[blockIdx.x] = "
                         "global_ns();")
    out = "\n".join(lines)
    out = _sub(out, "namespace {\n\nconstexpr int THREADS", """namespace {
__device__ unsigned long long prof_cycles[8];
__device__ unsigned long long prof_start[16384], prof_end[16384];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
constexpr int THREADS""")
    out = _sub(out, "  __shared__ int n_small, n_large;\n",
               "  __shared__ int n_small, n_large;\n  long long t_prev = 0;\n"
               "  if (threadIdx.x == 0 && blockIdx.x < 16384) "
               "prof_start[blockIdx.x] = global_ns();\n")
    return out + """
extern "C" int prof_read(unsigned long long* cycles, unsigned long long* t0,
                         unsigned long long* t1, int n) {
  cudaMemcpyFromSymbol(cycles, prof_cycles, sizeof(prof_cycles));
  cudaMemcpyFromSymbol(t0, prof_start, n * 8);
  cudaMemcpyFromSymbol(t1, prof_end, n * 8);
  unsigned long long z[8] = {0};
  cudaMemcpyToSymbol(prof_cycles, z, sizeof(z));
  return cudaDeviceSynchronize();
}
"""


VARIANTS = {
    "base": lambda: SRC,
    "no_bm": lambda: _sub(SRC, "  const float radius = sqrtf(",
                          "  return __fadd_rn(rate, u);\n"
                          "  const float radius = sqrtf("),
    "no_philox": lambda: _sub(
        SRC, "#pragma unroll\n  for (int r = 0; r < 10; ++r) {",
        "  return Words{c.x * 0x9E3779B9u ^ k0, (c.x + c.z) * 0x85EBCA6Bu ^ "
        "k1, 0u, 0u};\n#pragma unroll\n  for (int r = 0; r < 10; ++r) {"),
    "terms2": lambda: _sub(SRC, "DRAIN_TERMS = 4;", "DRAIN_TERMS = 2;"),
    "slice128": lambda: _sub(SRC, "DRAIN_SLICE = 64;", "DRAIN_SLICE = 128;"),
    "wait_grid": lambda: _sub(
        SRC, "    while (load_acquire(tally) < want) __nanosleep(256);",
        "    asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");"),
    "profile": lambda: _profile(SRC),
}


def _build_all(names) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(VARIANTS[name]())
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for ln in log.splitlines():
            if "spill" in ln or ("registers" in ln and "smem" in ln):
                print(json.dumps({"variant": name, "ptxas": ln.strip()}))
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fn = lib.emx_poisson_degrade
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (lib, fn)
    return libs


def _constant(name: str, pattern: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", pattern).group(1))


def _cases(device) -> dict:
    rng = np.random.default_rng(1)   # chip_smoke.training_batch's draws
    imgs = synthetic_micrographs(16, 512, seed=int(rng.integers(2 ** 31)))
    scales = (25.0 + 75.0 * rng.exponential(size=16)).astype(np.float32)
    ones = torch.ones((16, 512, 512), device=device)
    return {"training": (torch.from_numpy(imgs).to(device),
                         torch.from_numpy(scales).to(device)),
            "rate5": (ones, torch.full((16,), 5.0, device=device)),
            "rate200": (ones, torch.full((16,), 200.0, device=device))}


def _timeline(lib, grid: int) -> dict:
    """Pass cycles a block and the blocks resident over the span."""
    cycles = (ctypes.c_ulonglong * 8)()
    t0 = (ctypes.c_ulonglong * grid)()
    t1 = (ctypes.c_ulonglong * grid)()
    lib.prof_read(cycles, t0, t1, grid)
    start = np.array(t0[:], dtype=np.float64)
    end = np.array(t1[:], dtype=np.float64)
    end -= start.min()
    start -= start.min()
    probe = np.arange(0.0, end.max(), 250.0)
    resident = [int(((start <= x) & (end > x)).sum()) for x in probe]
    return {"pass_cycles_a_block": [cycles[i] / grid for i in (1, 2, 3)],
            "span_us": float(end.max() / 1e3),
            "block_us_mean": float((end - start).mean() / 1e3),
            "resident_mean": float(np.mean(resident)),
            "resident_every_quarter_us": resident[::4]}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("degrade_ablation measures the card: no CUDA device")
    names = sys.argv[1:] or list(VARIANTS)
    device = torch.device("cuda", 0)
    libs = _build_all(names)
    cases = _cases(device)
    refs = {c: poisson_degrade_reference(7, *v) for c, v in cases.items()}
    key = seed_tensor(7, device)
    for name in names:
        lib, fn = libs[name]
        src = VARIANTS[name]()
        tile = _constant("THREADS", src) * _constant("PER_THREAD", src)
        rescale_tile = _constant("RESCALE_TILE", src)
        for case, (imgs, scales) in cases.items():
            b, h, w = imgs.shape
            tiles, rtiles = -(-h * w // tile), -(-h * w // rescale_tile)
            out = torch.empty_like(imgs)
            scratch = torch.empty(3 * b, dtype=torch.int32, device=device)

            def call(phases):
                err = fn(imgs.data_ptr(), scales.data_ptr(), out.data_ptr(),
                         scratch.data_ptr(), b, h * w, key.data_ptr(), 0,
                         tiles, rtiles, phases,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call(3)
            torch.cuda.synchronize()
            row = {"variant": name, "case": case,
                   "equal": bool(torch.equal(out, refs[case])),
                   "ms": device_ms(lambda: call(3)),
                   "count_ms": device_ms(lambda: call(1)),
                   "rescale_ms": device_ms(lambda: call(2))}
            if name == "profile":
                lib.prof_read((ctypes.c_ulonglong * 8)(),
                              (ctypes.c_ulonglong * 1)(),
                              (ctypes.c_ulonglong * 1)(), 1)
                call(1)
                torch.cuda.synchronize()
                row.update(_timeline(lib, b * tiles))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

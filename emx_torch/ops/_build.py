"""Build the port's CUDA sources at first use.

Each `csrc/<name>.cu` exposes a plain C interface. nvcc compiles it for
sm_90a into `emx_torch/_build/lib<name>_<hash>.so`, where the hash
covers the source and the flags, so a stale library is never loaded;
ctypes loads it. No PyTorch headers, no torch.utils.cpp_extension, no
ninja: a build takes seconds. If nvcc fails, its output is raised.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_built: dict[str, "Built"] = {}


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc's wall time; 0.0 if the library existed
    log: str        # nvcc's output: ptxas registers and shared memory


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load(name: str) -> Built:
    """Compile `csrc/<name>.cu` unless its library exists; load it."""
    with _lock:
        if name in _built:
            return _built[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}_{digest}.so"
        seconds, log = 0.0, ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f"{so.name}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(src)], capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, so)
        _built[name] = Built(ctypes.CDLL(str(so)), so, seconds, log)
        return _built[name]

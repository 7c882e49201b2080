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
    seconds: float  # wall time until its nvcc ended; 0.0 if it existed
    log: str        # nvcc's output: ptxas registers and shared memory


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library(name: str) -> Path:
    """Where `csrc/<name>.cu`, built with NVCC_FLAGS, lives."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def load_all(names) -> dict[str, Built]:
    """Compile each `csrc/<name>.cu` whose library does not exist, one
    nvcc process per source, all started together; load them all. On a
    failure the other nvcc processes are killed and nvcc's output raised."""
    with _lock:
        todo = [n for n in dict.fromkeys(names) if n not in _built]
        procs: dict[str, tuple] = {}
        done: dict[str, tuple[float, str]] = {}
        t0 = time.perf_counter()
        try:
            for name in todo:
                so = _library(name)
                if so.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = BUILD_DIR / f"{so.name}.{os.getpid()}.tmp"
                proc = subprocess.Popen(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                procs[name] = (proc, tmp, so)
            for name, (proc, tmp, so) in procs.items():
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
                os.replace(tmp, so)
                # Wall time from the common start: builds overlap.
                done[name] = (time.perf_counter() - t0, log)
        finally:
            for proc, tmp, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
        for name in todo:
            so = _library(name)
            seconds, log = done.get(name, (0.0, ""))
            _built[name] = Built(ctypes.CDLL(str(so)), so, seconds, log)
        return {n: _built[n] for n in names}


def load(name: str) -> Built:
    """Compile `csrc/<name>.cu` unless its library exists; load it."""
    return load_all([name])[name]

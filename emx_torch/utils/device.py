"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
import functools
import subprocess

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; the CPU
    is used only when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return device


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block (a result that
    repeats on one card and library); the previous setting after it."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


@contextlib.contextmanager
def full_float32():
    """float32 convolutions and matrix products without TF32 inside the
    block (cuDNN's convolutions default to TF32 on the card); the
    previous settings after it."""
    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit of the first card, as
    `--query-gpu=name,power.limit --format=csv,noheader` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA card (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count

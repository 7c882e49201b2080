"""Structured JSONL metrics + plain-text mirror + throughput meter (copy
of emx/utils/metrics.py).

Replaces the reference's append-only text logs (`log.txt`, `val_log.txt`,
`discr_pred.txt` — gan-infilling-100.py:90-94,1811-1832) and its
`ExamplesPerSecondHook` (denoiser-multi-gpu.py:544-600) with one structured
logger that also writes the same human-readable mirror for parity.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any


class ThroughputMeter:
    """Average + instantaneous examples/sec, reported every `every` steps."""

    def __init__(self, batch_size: int, every: int = 100):
        self.batch_size = batch_size
        self.every = every
        self._start = time.perf_counter()
        self._last = self._start
        self._last_step = 0
        self._first_step: int | None = None

    def update(self, step: int) -> dict[str, float] | None:
        if self._first_step is None:
            # Exclude compile time of the first step from averages.
            self._first_step = step
            self._start = self._last = time.perf_counter()
            self._last_step = step
            return None
        if (step - self._last_step) < self.every:
            return None
        now = time.perf_counter()
        inst = self.batch_size * (step - self._last_step) / (now - self._last)
        avg = self.batch_size * (step - self._first_step) / (now - self._start)
        self._last, self._last_step = now, step
        return {"examples_per_sec": inst, "avg_examples_per_sec": avg}


class MetricsLogger:
    """JSONL metrics with an optional plain-text mirror.

    jsonl line: {"step": 10, "t": 1699..., "loss": 0.1, ...}
    """

    def __init__(self, log_dir: str | None, name: str = "metrics", mirror: bool = True):
        self.log_dir = log_dir
        self._jsonl = None
        self._mirror = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
            if mirror:
                self._mirror = open(os.path.join(log_dir, "log.txt"), "a")

    def log(self, step: int, **values: Any) -> None:
        rec = {"step": int(step), "t": time.time()}
        for k, v in values.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._mirror:
            kv = ", ".join(f"{k}: {rec[k]}" for k in values)
            self._mirror.write(f"Iter: {step}, {kv}\n")
            self._mirror.flush()

    def close(self) -> None:
        for f in (self._jsonl, self._mirror):
            if f:
                f.close()


def read_jsonl(path: str) -> list[dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def read_loss_log(path: str, key: str = "loss") -> list[float]:
    """Parse a plain-text log back into a loss series: the number after
    each `<key>:` (the analysis workflow of reference
    misc_py/read_loss_log.py)."""
    pat = re.compile(rf"{key}:\s*([-+0-9.eE]+)")
    out: list[float] = []
    with open(path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                try:
                    out.append(float(m.group(1)))
                except ValueError:
                    pass
    return out

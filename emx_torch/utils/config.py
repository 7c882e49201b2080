"""Config system (copy of emx/utils/config.py): dataclasses, one flag
parser and the `learning_rate.txt` hot reload.

Replaces the reference's three config mechanisms (module-top constants,
argparse→HParams, and the `learning_rate.txt` mid-training hot reload —
reference misc_py/denoiser-multi-gpu.py:39-122,1161-1167,1226-1341) with a
single dataclass-based system that preserves the hot-reload workflow.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Iterator, TypeVar

T = TypeVar("T")


def config_field(default: Any, help: str = "") -> Any:  # noqa: A002
    return dataclasses.field(default=default, metadata={"help": help})


@dataclasses.dataclass
class Config:
    """Base class for experiment configs.

    Subclass with typed fields; then `MyConfig.from_args(argv)` parses
    `--name=value` flags, and `cfg.replace(**kw)` returns an updated copy.
    """

    def replace(self: T, **kw: Any) -> T:
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls: type[T], d: dict[str, Any]) -> T:
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_args(cls: type[T], argv: list[str] | None = None) -> T:
        import argparse

        parser = argparse.ArgumentParser()
        for f in dataclasses.fields(cls):
            ftype = f.type if callable(f.type) else None
            kwargs: dict[str, Any] = {"default": f.default}
            if f.default is True or f.default is False:
                kwargs["type"] = lambda s: s.lower() in ("1", "true", "yes")
            elif ftype in (int, float, str):
                kwargs["type"] = ftype
            elif isinstance(f.default, (int, float, str)):
                kwargs["type"] = type(f.default)
            if isinstance(f.metadata.get("help"), str):
                kwargs["help"] = f.metadata["help"]
            parser.add_argument(f"--{f.name}", **kwargs)
        ns = parser.parse_args(argv)
        return cls(**vars(ns))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def load_overrides(path: str) -> dict[str, float]:
    """Read `key value` or bare-number override files.

    A bare number is returned as {"learning_rate": value}, preserving the
    reference's `learning_rate.txt` hot-reload contract
    (misc_py/denoiser-multi-gpu.py:1161-1167).
    """
    out: dict[str, float] = {}
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return out
    if not text:
        return out
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    for ln in lines:
        parts = ln.replace("=", " ").split()
        if len(parts) == 1:
            try:
                out["learning_rate"] = float(parts[0])
            except ValueError:
                pass
        elif len(parts) >= 2:
            try:
                out[parts[0]] = float(parts[1])
            except ValueError:
                pass
    return out


def watch_file(
    path: str, interval_s: float = 0.0
) -> Callable[[], dict[str, float] | None]:
    """Return a poller: call it each step; returns new overrides when the
    file's mtime changes (else None). Cheap enough to call per-step."""
    state = {"mtime": -1.0, "last_check": 0.0}

    def poll() -> dict[str, float] | None:
        now = time.monotonic()
        if interval_s and now - state["last_check"] < interval_s:
            return None
        state["last_check"] = now
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return None
        if mtime == state["mtime"]:
            return None
        state["mtime"] = mtime
        return load_overrides(path)

    return poll


def iter_shards(items: list[T], shard_index: int,
                shard_count: int) -> Iterator[T]:
    """Deterministic round-robin sharding of a work list across hosts:
    the items whose position is `shard_index` modulo `shard_count`."""
    for i, item in enumerate(items):
        if i % shard_count == shard_index:
            yield item

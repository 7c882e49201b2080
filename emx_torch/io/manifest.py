"""Dataset manifests: the framework's replacement for the reference's
compendium .mat stat records + TFRecord shards + copy-pasted split scripts
(DM3stoTIFs-batch/reaper.m:85-92, misc_py/TFRecord_creator.py:31-35,
misc_py/crop_arm_scans.py:11-13).

A manifest is a JSONL file: one record per example with its path, split,
and optional statistics. Splits are deterministic given a seed.

Port of emx/io/manifest.py, copied: the same JSONL records, key for key.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import json
import os
from typing import Any, Iterator

import numpy as np


@dataclasses.dataclass
class Manifest:
    records: list[dict[str, Any]]

    def paths(self, split: str | None = None) -> list[str]:
        return [r["path"] for r in self.records
                if split is None or r.get("split") == split]

    def __len__(self) -> int:
        return len(self.records)

    def filter(self, **kv: Any) -> "Manifest":
        return Manifest([r for r in self.records
                         if all(r.get(k) == v for k, v in kv.items())])

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r, default=_np_default) + "\n")

    @classmethod
    def load(cls, path: str) -> "Manifest":
        records = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        return cls(records)

    def shard(self, index: int, count: int) -> Iterator[dict[str, Any]]:
        """Per-host work ranges — one job replacing get_lq.m..get_lq10.m."""
        for i, r in enumerate(self.records):
            if i % count == index:
                yield r


def _np_default(o: Any) -> Any:
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))


def build_manifest(
    pattern: str,
    splits: tuple[float, float, float] = (0.70, 0.15, 0.15),
    seed: int = 0,
    stats: dict[str, dict[str, float]] | None = None,
) -> Manifest:
    """Glob files and assign deterministic train/val/test splits.

    Default fractions are the reference TFRecord_creator's 70/15/15
    (misc_py/TFRecord_creator.py:31-35).
    """
    paths = sorted(_glob.glob(pattern, recursive=True))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(paths))
    n_train = int(splits[0] * len(paths))
    n_val = int(splits[1] * len(paths))
    records = []
    for rank, idx in enumerate(order):
        split = ("train" if rank < n_train
                 else "val" if rank < n_train + n_val else "test")
        rec: dict[str, Any] = {"path": paths[idx], "split": split}
        if stats and paths[idx] in stats:
            rec["stats"] = stats[paths[idx]]
        records.append(rec)
    records.sort(key=lambda r: r["path"])
    return Manifest(records)


def split_manifest(m: Manifest) -> tuple[Manifest, Manifest, Manifest]:
    return (m.filter(split="train"), m.filter(split="val"), m.filter(split="test"))

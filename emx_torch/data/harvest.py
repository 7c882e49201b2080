"""Micrograph harvest (port of emx/data/harvest.py): DM3/DM4 corpus ->
census -> normalized TIFFs + stats manifest; stack extraction; crop
datasets.

  * harvester.m:1-76   -> `census()` (count imaging-mode images by size
    and mean-count thresholds)
  * reaper.m:1-98, get_lq.m..get_lq10.m -> `reap()` (decode -> filter ->
    square-crop + box-resize 2048 -> stats -> float32 TIFF + JSONL
    manifest; shard by host index)
  * dmX_stacks_to_TIFs.m:1-55 -> `extract_stacks()` (per-slice TIFF dirs)
  * crop_arm_scans.py / crop_stills_all.py -> `crop_dataset()` (split +
    non-overlapping 512 tiles)
  * data_from_compendiums.m -> `stats_to_csv()`

`reap` runs `harvest_preprocess` and `image_stats` on `device` (the card
unless the caller asks for the CPU): each file is resized on its own,
then the resized images' statistics are taken STATS_BATCH at a time,
where emx's `jax.jit(image_stats)` ran one image per call. Its manifest
records are emx's, key for key: the stats in the sorted key order that
emx's jitted dict comes back in, the raw-image stats from the host.
"""

from __future__ import annotations

import csv
import glob as _glob
import os
from typing import Iterable

import numpy as np
import torch

from emx_torch.data.crops import harvest_preprocess, tile_grid
from emx_torch.io.dm import DMDecodeError, read_dm
from emx_torch.io.manifest import Manifest
from emx_torch.io.tiff import read_tiff, write_tiff
from emx_torch.physics.stats import STAT_NAMES, image_stats
from emx_torch.utils.device import resolve_device

# Resized images whose statistics are taken in one batch (8 at 2048x2048
# hold ~0.4 GB of FFT work space on the card).
STATS_BATCH = 8


def find_dm_files(root: str) -> list[str]:
    out = []
    for ext in ("dm3", "dm4"):
        out += _glob.glob(os.path.join(root, "**", f"*.{ext}"), recursive=True)
    return sorted(out)


def census(
    paths: Iterable[str],
    min_side: int = 512,
    min_mean_counts: float = 0.01,
) -> dict:
    """Corpus census (harvester.m): counts by mode/size/mean thresholds."""
    counts = {"total": 0, "decode_failed": 0, "not_imaging": 0,
              "too_small": 0, "too_dim": 0, "usable": 0}
    for p in paths:
        counts["total"] += 1
        try:
            im = read_dm(p).image()
        except (DMDecodeError, OSError, KeyError):
            counts["decode_failed"] += 1
            continue
        if not im.is_imaging_mode:
            counts["not_imaging"] += 1
        elif min(im.data.shape[-2:]) < min_side:
            counts["too_small"] += 1
        elif float(np.mean(im.data)) < min_mean_counts:
            counts["too_dim"] += 1
        else:
            counts["usable"] += 1
    return counts


def raw_stats(data: np.ndarray) -> dict[str, float]:
    """Pre-resize stats of the raw decoded image (img_params.m:7-21),
    computed on host."""
    n_px = float(data.size)
    return {
        "smallest_dim": float(min(data.shape[-2:])),
        "height": float(data.shape[-2]),
        "width": float(data.shape[-1]),
        "num_px": n_px,
        "min": float(data.min()),
        "max": float(data.max()),
        "num_nonzero": float(np.count_nonzero(data)),
        "proportion_zero": float(np.count_nonzero(data)) / n_px,
        "num_negative": float((data < 0).sum()),
        "proportion_negative": float((data < 0).sum()) / n_px,
    }


def reap(
    paths: list[str],
    out_dir: str,
    shard_index: int = 0,
    shard_count: int = 1,
    size: int = 2048,
    min_side: int = 512,
    noise_cutoff: float = 0.02,
    device: str | torch.device = "cuda",
) -> Manifest:
    """Harvest usable 2D imaging-mode micrographs into normalized float32
    TIFFs with the full statistics record (reaper.m semantics: noise /
    signal cutoff 0.02 at reaper.m:4,62; per-file try/except)."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    records: list[dict] = []
    pending: list[tuple[str, np.ndarray, torch.Tensor]] = []
    n = 0

    def flush():
        nonlocal n
        if not pending:
            return
        try:
            batch = torch.stack([img for _, _, img in pending])
            stats_b = image_stats(batch)
            cols = {k: v.double().cpu().numpy() for k, v in stats_b.items()}
            host = batch.cpu().numpy()
        except Exception as e:  # the batch's files share its fault
            records.extend({"path": "", "source": p, "error": str(e)}
                           for p, _, _ in pending)
            pending.clear()
            return
        for i, (path, data, _) in enumerate(pending):
            try:
                stats = {k: float(cols[k][i]) for k in sorted(cols)}
                stats.update(raw_stats(data))
                if stats["noise_0to1"] > noise_cutoff and (
                        stats["stddev_0to1"] < noise_cutoff):
                    continue  # noise dominates signal
                lo, hi = stats["min_resized"], stats["max_resized"]
                norm = (host[i] - lo) / max(hi - lo, 1e-12)
                out_path = os.path.join(out_dir,
                                        f"reaping{shard_index}_{n}.tif")
                write_tiff(out_path, norm.astype(np.float32))
                records.append({"path": out_path, "source": path,
                                "split": "train", "stats": stats})
                n += 1
            except Exception as e:  # per-file guard, as reaper.m:80-82
                records.append({"path": "", "source": path, "error": str(e)})
        pending.clear()

    for i, path in enumerate(paths):
        if i % shard_count != shard_index:
            continue
        try:
            im = read_dm(path).image()
            data = np.asarray(im.data, np.float32)
            if data.ndim != 2 or not im.is_imaging_mode:
                continue
            if min(data.shape) < min_side:
                continue
            img = harvest_preprocess(torch.tensor(data, device=device), size)
            pending.append((path, data, img))
        except Exception as e:  # per-file guard, as reaper.m:80-82
            records.append({"path": "", "source": path, "error": str(e)})
        if len(pending) >= STATS_BATCH:
            flush()
    flush()
    manifest = Manifest([r for r in records if r.get("path")])
    manifest.save(os.path.join(out_dir, f"manifest_{shard_index}.jsonl"))
    return manifest


def extract_stacks(paths: list[str], out_dir: str) -> list[str]:
    """DM stacks -> per-slice float32 TIFF directories stackN/imgM.tif
    (dmX_stacks_to_TIFs.m:1-55)."""
    os.makedirs(out_dir, exist_ok=True)
    dirs = []
    n = 0
    for path in paths:
        try:
            im = read_dm(path).image()
        except (DMDecodeError, OSError, KeyError):
            continue
        data = np.asarray(im.data, np.float32)
        if data.ndim != 3 or data.shape[0] < 2:
            continue
        stack_dir = os.path.join(out_dir, f"stack{n}")
        os.makedirs(stack_dir, exist_ok=True)
        for m in range(data.shape[0]):
            write_tiff(os.path.join(stack_dir, f"img{m + 1}.tif"), data[m])
        dirs.append(stack_dir)
        n += 1
    return dirs


def crop_dataset(
    manifest: Manifest,
    out_dir: str,
    tile: int = 512,
    splits: tuple[float, float, float] = (0.75, 0.10, 0.15),
    seed: int = 0,
) -> dict[str, int]:
    """Split whole micrographs then emit non-overlapping tiles per split
    (crop_arm_scans.py:1-62: 75/10/15 split, 512 tiles)."""
    rng = np.random.default_rng(seed)
    paths = manifest.paths()
    order = rng.permutation(len(paths))
    n_train = int(splits[0] * len(paths))
    n_val = int(splits[1] * len(paths))
    counts = {"train": 0, "val": 0, "test": 0}
    for rank, idx in enumerate(order):
        split = ("train" if rank < n_train
                 else "val" if rank < n_train + n_val else "test")
        img = read_tiff(paths[idx])
        tiles = tile_grid(torch.from_numpy(img), tile).numpy()
        split_dir = os.path.join(out_dir, split)
        os.makedirs(split_dir, exist_ok=True)
        for t in tiles:
            write_tiff(os.path.join(split_dir, f"tile{counts[split]}.tif"), t)
            counts[split] += 1
    return counts


def pack_crops(crop_dir: str, out_path: str, tile: int = 512,
               dtype=np.float32) -> int:
    """Pack a directory of same-size TIFF crops into one (N, tile, tile)
    .npy, the training fast path (memmap-able). An integer `dtype`
    stores each crop rescaled to the full integer range (quantize_pack):
    training renormalises every crop, so the per-crop affine cancels.
    Returns N."""
    paths = sorted(_glob.glob(os.path.join(crop_dir, "*.tif")))
    if not paths:
        return 0
    out = np.empty((len(paths), tile, tile), np.float32)
    for i, p in enumerate(paths):
        out[i] = read_tiff(p, fallback_shape=(tile, tile))[:tile, :tile]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.save(out_path, quantize_pack(out, dtype))
    return len(paths)


def quantize_pack(stack: np.ndarray, dtype=np.uint16) -> np.ndarray:
    """Rescale each crop of (N, H, W) float to the full range of an
    integer `dtype` (no-op for float dtypes); see pack_crops."""
    if not np.issubdtype(dtype, np.integer):
        return stack.astype(dtype)
    maxv = float(np.iinfo(dtype).max)
    lo = stack.min(axis=(-2, -1), keepdims=True)
    hi = stack.max(axis=(-2, -1), keepdims=True)
    span = np.maximum(hi - lo, 1e-12)
    return np.round((stack - lo) / span * maxv).astype(dtype)


def stats_to_csv(manifests: list[Manifest], csv_path: str) -> None:
    """Flatten stat compendiums to CSV (data_from_compendiums.m:1-133)."""
    os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(("path",) + STAT_NAMES)
        for m in manifests:
            for r in m.records:
                if "stats" in r:
                    writer.writerow(
                        [r["path"]] + [r["stats"].get(k, "") for k in STAT_NAMES]
                    )

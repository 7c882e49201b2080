"""Ancillary file utilities (port of emx/data/misc_files.py; reference
misc_py plumbing).

Small but real workflow pieces the reference keeps as standalone
scripts:
  * `partition_dataset` — shuffled 70/15/15 copy-partition with
    per-split renaming (misc_py/filecopy.py:1-38, throwawayFilecopy.py).
  * `noise_census`     — per-image Laplacian noise-sigma census over a
    directory (misc_py/img_info.py:9-33).
  * `video_to_slices`  — mp4 -> per-frame image slices
    (misc_py/mp4_to_slices.py); requires cv2, gated.
  * `images_to_text`   — OCR a directory of images
    (misc_py/images_to_text.py:13-42); requires pytesseract, gated.

The gated functions raise a clear ImportError naming the missing
dependency instead of failing at import time when it is absent
(emx's tests round-trip video_to_slices where cv2 is installed;
images_to_text stays gated where pytesseract is missing).
"""

from __future__ import annotations

import os
import shutil

import numpy as np


def partition_dataset(
    in_dir: str,
    out_dir: str,
    splits: tuple[float, float, float] = (0.7, 0.15, 0.15),
    names: tuple[str, str, str] = ("train", "val", "test"),
    seed: int = 0,
    ext: str = ".tif",
) -> dict[str, int]:
    """Shuffle files in `in_dir` and copy them into train/val/test
    subdirectories of `out_dir`, renamed `<split><i><ext>`
    (filecopy.py semantics, deterministic shuffle instead of
    random.shuffle)."""
    files = sorted(os.listdir(in_dir))
    rng = np.random.default_rng(seed)
    rng.shuffle(files)
    n = len(files)
    bounds = [0, int(splits[0] * n), int((splits[0] + splits[1]) * n), n]
    counts: dict[str, int] = {}
    for k, split in enumerate(names):
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        chunk = files[bounds[k]: bounds[k + 1]]
        for i, f in enumerate(chunk, 1):
            shutil.copyfile(
                os.path.join(in_dir, f),
                os.path.join(out_dir, split, f"{split}{i}{ext}"),
            )
        counts[split] = len(chunk)
    return counts


def noise_census(paths: list[str]) -> list[dict]:
    """Laplacian noise-sigma census (img_info.py): returns
    [{"path", "noise", "mean"}] per readable image."""
    import torch

    from emx_torch.io.tiff import read_tiff
    from emx_torch.physics.stats import estimate_noise

    out = []
    for p in paths:
        try:
            img = read_tiff(p)
        except Exception:
            continue
        out.append({
            "path": p,
            "noise": float(estimate_noise(torch.from_numpy(
                np.asarray(img, np.float32)))),
            "mean": float(np.mean(img)),
        })
    return out


def video_to_slices(video_path: str, out_dir: str, every_n: int = 1,
                    prefix: str = "frame") -> int:
    """Extract every `every_n`-th frame of a video to PNGs
    (mp4_to_slices.py). Requires OpenCV."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "video_to_slices requires opencv-python (cv2), which is not "
            "installed in this environment") from e
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    n = saved = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if n % every_n == 0:
            cv2.imwrite(os.path.join(out_dir, f"{prefix}{saved}.png"),
                        frame)
            saved += 1
        n += 1
    cap.release()
    return saved


def images_to_text(dir_path: str) -> str:
    """OCR every image in a directory into one text blob
    (images_to_text.py). Requires pytesseract."""
    try:
        import pytesseract
    except ImportError as e:
        raise ImportError(
            "images_to_text requires pytesseract, which is not installed "
            "in this environment") from e
    from PIL import Image

    text = []
    for f in sorted(os.listdir(dir_path)):
        try:
            with Image.open(os.path.join(dir_path, f)) as im:
                text.append(pytesseract.image_to_string(im.convert("L")))
        except OSError:
            continue
    return "\n".join(text)

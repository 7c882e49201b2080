"""TIFF and .npy stack IO (port of emx/io/tiff.py).

The reference exchanges all intermediate data as float32 TIFFs
(DM3stoTIFs-batch/reaper.m:85-92, misc_py scripts passim) and packs
small datasets as (N, 96, 96, 1) .npy stacks
(small_scans/convert_to_numpy.py).

emx reads and writes through PIL. The port reads and writes baseline
TIFF itself, in numpy, so that it needs no PIL: uncompressed, one page,
strips, 8/16/32-bit integers and float32 (and float64), either byte
order, one sample per pixel (several, contiguous, are
averaged over the first three to grey, as emx does for RGB). That covers
every file emx's `write_tiff` (PIL mode 'F') writes, and PIL reads what
`write_tiff` writes back bit for bit. Other formats (PNG, JPEG,
compressed or tiled TIFF) go through PIL when it imports; without PIL
they raise, naming the format.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# TIFF tags (TIFF 6.0, section 8).
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_BYTES = 273, 277, 278, 279
_PLANAR, _PREDICTOR, _TILE_OFFSETS, _SAMPLE_FORMAT = 284, 317, 324, 339
# Field type -> (struct code, bytes).
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 16: ("Q", 8)}
# (SampleFormat, bits) -> numpy kind; SampleFormat 1 unsigned, 2 signed,
# 3 IEEE float.
_DTYPES = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (2, 8): "i1",
           (2, 16): "i2", (2, 32): "i4", (3, 32): "f4", (3, 64): "f8"}
_FORMAT_OF = {v: k[0] for k, v in _DTYPES.items()}
# What write_tiff writes: every one of these, in either byte order, PIL
# reads back bit for bit (PIL reads no big-endian 32-bit unsigned TIFF).
_WRITTEN = ("u1", "u2", "i2", "i4", "f4")
_MAGICS = ((b"\x89PNG", "PNG"), (b"\xff\xd8", "JPEG"), (b"GIF8", "GIF"),
           (b"BM", "BMP"))


class TiffError(ValueError):
    """A file that is not a readable TIFF (truncated, malformed)."""


class TiffUnsupported(TiffError):
    """A TIFF feature the decoder does not read; PIL may."""


def _format_name(head: bytes, path: str) -> str:
    for magic, name in _MAGICS:
        if head.startswith(magic):
            return name
    ext = os.path.splitext(path)[1].lstrip(".").upper()
    return ext or "unknown"


def _ifd(raw: bytes, order: str) -> dict[int, tuple]:
    """The first image file directory: tag -> values."""
    (offset,) = struct.unpack_from(order + "I", raw, 4)
    (n,) = struct.unpack_from(order + "H", raw, offset)
    tags: dict[int, tuple] = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack_from(
            order + "HHI4s", raw, offset + 2 + 12 * i)
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * count
        data = value if nbytes <= 4 else raw[
            struct.unpack(order + "I", value)[0]:][:nbytes]
        if len(data) < nbytes:
            raise TiffError(f"tag {tag} runs past the end of the file")
        tags[tag] = struct.unpack(order + code * count, data[:nbytes])
    return tags


def decode_tiff(raw: bytes) -> np.ndarray:
    """The first page of a baseline TIFF as an array of its own dtype,
    (H, W) or (H, W, samples). Raises TiffError on what it does not
    read: compression, tiles, predictors, planar samples, BigTIFF."""
    order = {b"II": "<", b"MM": ">"}.get(raw[:2])
    if order is None or struct.unpack_from(order + "H", raw, 2)[0] != 42:
        raise TiffUnsupported("not a classic TIFF")
    tags = _ifd(raw, order)
    get = lambda tag, default=None: tags.get(tag, (default,))  # noqa: E731
    if get(_COMPRESSION, 1)[0] != 1:
        raise TiffUnsupported(f"compression {get(_COMPRESSION)[0]} is not read")
    if _TILE_OFFSETS in tags:
        raise TiffUnsupported("tiled TIFF is not read")
    if get(_PREDICTOR, 1)[0] != 1:
        raise TiffUnsupported("predictors are not read")
    samples = get(_SAMPLES, 1)[0]
    if samples > 1 and get(_PLANAR, 1)[0] != 1:
        raise TiffUnsupported("planar samples are not read")
    if get(_PHOTOMETRIC, 1)[0] not in (1, 2):
        raise TiffUnsupported(f"photometric {get(_PHOTOMETRIC)[0]} is not read")
    bits = set(tags.get(_BITS, (1,)))
    fmts = set(tags.get(_SAMPLE_FORMAT, (1,)))
    if len(bits) != 1 or len(fmts) != 1:
        raise TiffUnsupported("mixed sample types are not read")
    kind = _DTYPES.get((fmts.pop(), bits.pop()))
    if kind is None:
        raise TiffUnsupported("sample type is not read")
    w, h = get(_WIDTH)[0], get(_LENGTH)[0]
    if w is None or h is None or _STRIP_OFFSETS not in tags:
        raise TiffError("no image data")
    dtype = np.dtype(order + kind)
    need = w * h * samples * dtype.itemsize
    offsets = tags[_STRIP_OFFSETS]
    counts = tags.get(_STRIP_BYTES) or (need,)
    data = b"".join(raw[o:o + c] for o, c in zip(offsets, counts))
    if len(data) < need:
        raise TiffError(f"image data truncated: {len(data)} of {need} bytes")
    arr = np.frombuffer(data, dtype, count=w * h * samples)
    return arr.reshape((h, w, samples) if samples > 1 else (h, w))


def _read_with_pil(path: str, head: bytes) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise TiffError(f"{path}: reading {_format_name(head, path)} needs "
                        f"PIL, which is not installed") from None
    with Image.open(path) as im:
        return np.asarray(im, dtype=np.float32)


def read_tiff(path: str, fallback_shape: tuple[int, int] | None = None
              ) -> np.ndarray:
    """Read an image as float32 (H, W); RGB(A) collapses to grey.

    With `fallback_shape`, a failed read returns a neutral 0.5 image
    instead of raising: the reference trainers' guard behavior
    (misc_py/denoiser-multi-gpu.py:805-809).
    """
    try:
        with open(path, "rb") as f:
            raw = f.read()
        try:
            arr = decode_tiff(raw).astype(np.float32)
        except TiffUnsupported:
            arr = _read_with_pil(path, raw[:8])
        if arr.ndim == 3:  # collapse RGB(A) to grey
            arr = arr[..., :3].mean(axis=-1)
        return arr
    except Exception:
        if fallback_shape is not None:
            return np.full(fallback_shape, 0.5, dtype=np.float32)
        raise


def encode_tiff(img: np.ndarray, dtype=np.float32,
                byteorder: str = "<") -> bytes:
    """A baseline TIFF of a 2-D image: header, the data in one strip,
    then the directory (its offset word-aligned)."""
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError(f"write_tiff takes a 2-D image, got {img.shape}")
    dt = np.dtype(dtype).newbyteorder(byteorder)
    if dt.str[1:] not in _WRITTEN:
        raise ValueError(f"write_tiff writes {_WRITTEN}, not "
                         f"{np.dtype(dtype)}")
    h, w = img.shape
    data = np.ascontiguousarray(img.astype(dt)).tobytes()
    order = byteorder
    ifd_at = 8 + len(data) + (len(data) & 1)
    entries = [(_WIDTH, 4, w), (_LENGTH, 4, h),
               (_BITS, 3, 8 * dt.itemsize), (_COMPRESSION, 3, 1),
               (_PHOTOMETRIC, 3, 1), (_STRIP_OFFSETS, 4, 8),
               (_SAMPLES, 3, 1), (_ROWS_PER_STRIP, 4, h),
               (_STRIP_BYTES, 4, len(data)), (_PLANAR, 3, 1),
               (_SAMPLE_FORMAT, 3, _FORMAT_OF[dt.str[1:]])]
    ifd = struct.pack(order + "H", len(entries))
    for tag, typ, value in entries:
        packed = struct.pack(order + _TYPES[typ][0], value).ljust(4, b"\0")
        ifd += struct.pack(order + "HHI", tag, typ, 1) + packed
    ifd += struct.pack(order + "I", 0)
    head = (b"II" if order == "<" else b"MM") + struct.pack(
        order + "HI", 42, ifd_at)
    return head + data + b"\0" * (len(data) & 1) + ifd


def write_tiff(path: str, img: np.ndarray, dtype=np.float32,
               byteorder: str = "<") -> None:
    """Write a 2-D image as an uncompressed TIFF of `dtype` (float32 by
    default, as emx writes; uint8, uint16, int16 or int32) in
    `byteorder` ('<' little, '>' big)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    raw = encode_tiff(img, dtype, byteorder)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
    os.replace(tmp, path)


def write_npy_stack(path: str, imgs: list[np.ndarray]) -> None:
    """Pack images to an (N, H, W, 1) float32 stack
    (small_scans/convert_to_numpy.py:1-21 semantics)."""
    stack = np.stack([np.asarray(i, np.float32) for i in imgs])[..., None]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, stack)


def read_npy_stack(path: str) -> np.ndarray:
    return np.load(path).astype(np.float32)

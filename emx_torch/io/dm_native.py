"""ctypes bindings for the C++ DM3/DM4 decoder (native/dmfile.cc).

The native decoder is the fast path for the bulk harvest workload (the
reference's MATLAB readers took seconds per file; see ReadDMFile.m:63
timing note). Falls back cleanly when the shared library isn't built:
`available()` returns False and emx_torch.io.dm uses the Python parser.

Build: `make -C native` (produces native/build/libemx_dm.so).

Port of emx/io/dm_native.py, copied; `native/` stays shared with emx.
Whether the library is built decides only which decoder parses a file.
"""

from __future__ import annotations

import ctypes
import json
import os

import numpy as np

_LIB = None
_SEARCHED = False


def _find_lib() -> ctypes.CDLL | None:
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [
        os.path.join(here, "native", "build", "libemx_dm.so"),
        os.path.join(os.path.dirname(__file__), "libemx_dm.so"),
    ]
    for c in candidates:
        if os.path.exists(c):
            try:
                lib = ctypes.CDLL(c)
                lib.emx_dm_decode.restype = ctypes.c_void_p
                lib.emx_dm_decode.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t,
                    ctypes.POINTER(ctypes.c_char_p),   # json metadata (malloc'd)
                    ctypes.POINTER(ctypes.c_size_t),   # data nbytes
                ]
                lib.emx_dm_free.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                _LIB = lib
                return _LIB
            except OSError:
                continue
    return None


def available() -> bool:
    return _find_lib() is not None


def read_dm(path: str):
    """Decode via the C++ library; returns an emx_torch.io.dm.DMFile whose tag
    tree holds just the image-relevant entries (ImageList subtree)."""
    from emx_torch.io import dm as _dm

    lib = _find_lib()
    if lib is None:
        raise RuntimeError("native DM decoder not built (make -C native)")
    with open(path, "rb") as f:
        raw = f.read()
    meta_p = ctypes.c_char_p()
    nbytes = ctypes.c_size_t()
    data_p = lib.emx_dm_decode(raw, len(raw), ctypes.byref(meta_p), ctypes.byref(nbytes))
    if not meta_p.value:
        raise _dm.DMDecodeError(f"native decoder failed on {path}")
    try:
        meta = json.loads(meta_p.value.decode())
    finally:
        lib.emx_dm_free(data_p, meta_p)
    if "error" in meta:
        raise _dm.DMDecodeError(meta["error"])
    # Re-read payloads through numpy using byte offsets the C++ side reports;
    # zero extra parsing work in Python.
    image_list: dict = {}
    for i, im in enumerate(meta["images"], start=1):
        arr = np.frombuffer(
            raw, dtype=np.dtype(im["dtype"]), count=im["count"], offset=im["offset"]
        )
        entry = {
            "Name": im.get("name", ""),
            "ImageData": {
                "Calibrations": {
                    "Dimension": {"1": {"Scale": np.float32(im.get("scale", 1.0)),
                                        "Units": im.get("units", "")}}
                },
                "Dimensions": {
                    str(j + 1): np.uint32(d) for j, d in enumerate(im["dims"])
                },
                "Data": arr,
            },
            "ImageTags": {"Microscope Info": {
                "Operation Mode": im.get("operation_mode", "")}},
        }
        image_list[str(i)] = entry
    return _dm.DMFile(
        version=meta["version"],
        data_little_endian=bool(meta["data_le"]),
        tags={"ImageList": image_list},
    )

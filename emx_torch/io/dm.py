"""DM3/DM4 (Gatan DigitalMicrograph) file decode/encode.

A clean-room reader for the tag-tree container format, with the combined
capabilities of the reference's three MATLAB readers
(DM3stoTIFs-batch/ReadDMFile.m:1-409, dmread.m:1-243, DM3Import.m:1-691):
version 3 (uint32 counts) and version 4 (uint64 counts) files, big-endian
tag headers with little- or big-endian data payloads, structs, strings,
arrays and struct arrays, and ImageList/ImageData extraction (image data,
dimensions, calibration scale/units).

Format summary (as implemented by the reference readers):
  header   : u32be version (3|4), LLong total bytes, u32be data-is-LE flag
  tag group: u8 sorted, u8 open, LLong ntags, then ntags tag entries
  tag entry: u8 kind (20=subgroup, 21=data), u16be label length, label,
             [v4: u64be total bytes], then subgroup or data
  tag data : u32be magic 0x25252525 ('%%%%'), LLong definition length,
             then a self-describing definition stream of LLongs followed
             by the payload (simple scalar | struct | string | array)
  LLong    : u32be in v3, u64be in v4

`write_dm` synthesizes well-formed files — the test corpus the reference
never shipped (SURVEY.md §7 hard part 4).

This module is the pure-Python path; `emx_torch.io.dm_native` wraps the C++
decoder with identical semantics, and `read_dm` prefers it when built.

Port of emx/io/dm.py, copied (emx's module imports no JAX, but the port
imports nothing of emx). The decoder, C++ or Python, is the only thing
chosen by what is installed (`native/build/libemx_dm.so`, which a clean
checkout does not hold, so the tests' harvest and the card's run take
the Python parser); no device or kernel choice depends on it.
"""

from __future__ import annotations

import dataclasses
import io
import struct as _struct
from typing import Any, BinaryIO

import numpy as np

TAG_GROUP = 20
TAG_DATA = 21
MAGIC = 0x25252525  # '%%%%'

# DM type code -> numpy dtype (endian applied at read time).
_SIMPLE_TYPES: dict[int, str] = {
    2: "i2", 3: "i4", 4: "u2", 5: "u4", 6: "f4", 7: "f8",
    8: "u1", 9: "i1", 10: "i1", 11: "i8", 12: "u8",
}
T_STRUCT = 15
T_STRING = 18
T_ARRAY = 20

# Gatan ImageData.DataType enum -> numpy dtype (DM3Import.m semantics).
GATAN_DATA_TYPES: dict[int, str] = {
    1: "i2", 2: "f4", 3: "c8", 5: "c8", 6: "u1", 7: "i4",
    9: "i1", 10: "u2", 11: "u4", 12: "f8", 13: "c16", 14: "u1",
    39: "i8", 40: "u8",
}


class DMDecodeError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes, version: int = 3, data_le: bool = True):
        self.d = data
        self.p = 0
        self.version = version
        self.data_le = data_le

    def bytes(self, n: int) -> bytes:
        if self.p + n > len(self.d):
            raise DMDecodeError(
                f"truncated file: need {n} bytes at offset {self.p}, "
                f"have {len(self.d) - self.p}"
            )
        out = self.d[self.p : self.p + n]
        self.p += n
        return out

    def u8(self) -> int:
        return self.bytes(1)[0]

    def be(self, fmt: str) -> int:
        size = _struct.calcsize(fmt)
        return _struct.unpack(">" + fmt, self.bytes(size))[0]

    def llong(self) -> int:
        """Version-dependent count: u32be (v3) / u64be (v4)
        (ReadDMFile.m GetLLong:372-380)."""
        return self.be("I") if self.version == 3 else self.be("Q")

    def string(self, n: int) -> str:
        return self.bytes(n).decode("latin-1")

    def simple(self, code: int, num: int = 1) -> Any:
        dt = np.dtype(("<" if self.data_le else ">") + _SIMPLE_TYPES[code])
        raw = self.bytes(dt.itemsize * num)
        if code == 9 and num > 1:  # char array -> str
            return raw.decode("latin-1")
        # Normalize to native byte order for downstream compute.
        arr = np.frombuffer(raw, dtype=dt, count=num).astype(
            dt.newbyteorder("="), copy=False
        )
        return arr[0] if num == 1 else arr.copy()


@dataclasses.dataclass
class DMFile:
    """Parsed DM file: full tag tree plus convenience image accessors."""

    version: int
    data_little_endian: bool
    tags: dict[str, Any]

    def walk(self, path: str) -> Any:
        """Fetch a value by space-separated tag path; numerals address
        unnamed/indexed entries 1-based (ReadDMFile.m celltags:30-35)."""
        node: Any = self.tags
        for part in path.split():
            if not isinstance(node, dict) or part not in node:
                raise KeyError(path)
            node = node[part]
        return node

    def num_images(self) -> int:
        return len(self.walk("ImageList"))

    def image(self, index: int | None = None) -> "DMImage":
        """Extract an image. Default picks the largest-data entry (the real
        image rather than the thumbnail; the reference hardcodes entry 2)."""
        image_list = self.walk("ImageList")
        keys = list(image_list)
        if index is None:
            def datasize(k):
                try:
                    return np.asarray(image_list[k]["ImageData"]["Data"]).size
                except Exception:
                    return -1
            key = max(keys, key=datasize)
        else:
            key = keys[index]
        entry = image_list[key]
        idata = entry["ImageData"]
        dims = [int(np.asarray(v).item()) for v in idata["Dimensions"].values()]
        data = np.asarray(idata["Data"])
        if "DataType" in idata:
            code = int(np.asarray(idata["DataType"]).item())
            if code in GATAN_DATA_TYPES and data.dtype.kind in "iuf":
                want = np.dtype(GATAN_DATA_TYPES[code])
                if want.kind == "c" and data.dtype.kind == "f":
                    data = data.view(want)
        # DM stores x fastest; numpy (z, y, x) C-order.
        shape = list(reversed(dims))
        data = data.reshape(shape)
        scale, units = 1.0, ""
        try:
            cal = idata["Calibrations"]["Dimension"]
            first = next(iter(cal.values()))
            scale = float(np.asarray(first["Scale"]).item())
            units = str(first["Units"])
        except Exception:
            pass
        name = entry.get("Name", "")
        imtags = entry.get("ImageTags", {})
        return DMImage(data=data, scale=scale, units=units, name=str(name),
                       tags=imtags if isinstance(imtags, dict) else {})


@dataclasses.dataclass
class DMImage:
    data: np.ndarray
    scale: float
    units: str
    name: str = ""
    tags: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def is_imaging_mode(self) -> bool:
        """True when acquired in IMAGING (not DIFFRACTION) mode — the
        harvest filter `InImageMode == 1` (reaper.m / harvester.m)."""
        try:
            mode = self.tags["Microscope Info"]["Operation Mode"]
            return "IMAG" in str(mode).upper()
        except Exception:
            return True


def _parse_group(r: _Reader) -> dict[str, Any]:
    r.u8()  # sorted
    r.u8()  # open
    ntags = r.llong()
    out: dict[str, Any] = {}
    for i in range(1, ntags + 1):
        kind = r.u8()
        label_len = r.be("H")
        label = r.string(label_len) or str(i)
        if r.version == 4:
            r.be("Q")  # total bytes of this entry (skippable hint)
        if kind == TAG_GROUP:
            value = _parse_group(r)
        elif kind == TAG_DATA:
            value = _parse_data(r)
        else:
            raise DMDecodeError(f"unknown tag entry kind {kind} at offset {r.p}")
        key = label
        n = 2
        while key in out:  # duplicate labels keep both entries
            key = f"{label}#{n}"
            n += 1
        out[key] = value
    return out


def _parse_struct_def(r: _Reader) -> list[int]:
    r.llong()  # struct name length (always consumed; names are empty)
    nfields = r.llong()
    field_types = []
    for _ in range(nfields):
        r.llong()  # field name length
        field_types.append(r.llong())
    return field_types


def _read_struct_body(r: _Reader, field_types: list[int]) -> tuple:
    return tuple(r.simple(t) for t in field_types)


def _parse_data(r: _Reader) -> Any:
    magic = r.be("I")
    if magic != MAGIC:
        raise DMDecodeError(f"bad tag data magic {magic:#x} at offset {r.p}")
    r.llong()  # definition length (stream is self-describing)
    return _parse_typed(r)


def _parse_typed(r: _Reader) -> Any:
    code = r.llong()
    if code in _SIMPLE_TYPES:
        return r.simple(code)
    if code == T_STRUCT:
        return _read_struct_body(r, _parse_struct_def(r))
    if code == T_STRING:
        n = r.be("I")
        return r.string(n)
    if code == T_ARRAY:
        elem = r.llong()
        if elem == T_STRUCT:
            field_types = _parse_struct_def(r)
            n = r.llong()
            return [_read_struct_body(r, field_types) for _ in range(n)]
        n = r.llong()
        if elem == 4:
            # ushort arrays hold UTF-16 strings (labels) as well as data;
            # return the raw array — DMImage decodes strings contextually.
            return r.simple(elem, n) if n else np.zeros(0, np.uint16)
        if elem in _SIMPLE_TYPES:
            return r.simple(elem, n)
        raise DMDecodeError(f"unsupported array element type {elem}")
    raise DMDecodeError(f"unrecognized data type {code} at offset {r.p}")


def parse_dm(data: bytes) -> DMFile:
    head = _Reader(data)
    version = head.be("I")
    if version not in (3, 4):
        raise DMDecodeError(f"not a DM3/DM4 file (version={version})")
    head.version = version
    head.llong()  # total bytes
    data_le = head.be("I") == 1
    r = _Reader(data, version=version, data_le=data_le)
    r.p = head.p
    tags = _parse_group(r)
    return DMFile(version=version, data_little_endian=data_le, tags=tags)


def read_dm(path: str, prefer_native: bool = True) -> DMFile:
    """Read a .dm3/.dm4 file. Uses the C++ decoder when built (fast path
    for the harvest pipeline), falling back to pure Python."""
    if prefer_native:
        try:
            from emx_torch.io import dm_native

            if dm_native.available():
                return dm_native.read_dm(path)
        except Exception:
            pass
    with open(path, "rb") as f:
        return parse_dm(f.read())


def dm_image(path: str, index: int | None = None) -> DMImage:
    return read_dm(path).image(index)


# --------------------------------------------------------------------------
# Encoder — synthesizes well-formed DM3/DM4 files for tests and simulators.
# --------------------------------------------------------------------------


class _Writer:
    def __init__(self, version: int, data_le: bool):
        self.version = version
        self.data_le = data_le
        self.buf = io.BytesIO()

    def be(self, fmt: str, *vals: int) -> None:
        self.buf.write(_struct.pack(">" + fmt, *vals))

    def llong(self, v: int) -> None:
        self.be("I" if self.version == 3 else "Q", v)

    def raw(self, b: bytes) -> None:
        self.buf.write(b)


def _encode_value(w: _Writer, value: Any) -> None:
    """Encode one tag-data payload (magic + definition + data)."""
    w.be("I", MAGIC)
    body = _Writer(w.version, w.data_le)
    if isinstance(value, str):
        deflen = 2
        body.llong(T_STRING)
        body.be("I", len(value))
        body.raw(value.encode("latin-1"))
    elif isinstance(value, tuple):  # struct of scalars
        codes = [_np_code(np.asarray(v).dtype) for v in value]
        deflen = 3 + 2 * len(value)
        body.llong(T_STRUCT)
        body.llong(0)
        body.llong(len(value))
        for c in codes:
            body.llong(0)
            body.llong(c)
        for v, c in zip(value, codes):
            body.raw(_np_bytes(np.asarray(v), w.data_le))
    else:
        arr = np.asarray(value)
        if arr.ndim == 0:
            deflen = 1
            body.llong(_np_code(arr.dtype))
            body.raw(_np_bytes(arr, w.data_le))
        else:
            deflen = 3
            body.llong(T_ARRAY)
            body.llong(_np_code(arr.dtype))
            body.llong(arr.size)
            body.raw(_np_bytes(arr.reshape(-1), w.data_le))
    w.llong(deflen)
    w.raw(body.buf.getvalue())


_NP_TO_CODE = {
    "int16": 2, "int32": 3, "uint16": 4, "uint32": 5, "float32": 6,
    "float64": 7, "uint8": 10, "int8": 10, "int64": 11, "uint64": 12,
    "bool": 8,
}


def _np_code(dt: np.dtype) -> int:
    name = np.dtype(dt).name
    if name not in _NP_TO_CODE:
        raise ValueError(f"cannot encode dtype {name} in DM tag")
    return _NP_TO_CODE[name]


def _np_bytes(arr: np.ndarray, little: bool) -> bytes:
    return arr.astype(arr.dtype.newbyteorder("<" if little else ">")).tobytes()


def _encode_group(w: _Writer, tags: dict[str, Any]) -> None:
    w.be("BB", 1, 0)  # sorted, open
    w.llong(len(tags))
    for label, value in tags.items():
        name = "" if label.isdigit() else label.split("#")[0]
        is_group = isinstance(value, dict)
        entry = _Writer(w.version, w.data_le)
        if is_group:
            _encode_group(entry, value)
        else:
            _encode_value(entry, value)
        payload = entry.buf.getvalue()
        w.be("B", TAG_GROUP if is_group else TAG_DATA)
        w.be("H", len(name))
        w.raw(name.encode("latin-1"))
        if w.version == 4:
            w.be("Q", len(payload))
        w.raw(payload)


def encode_dm(tags: dict[str, Any], version: int = 3, data_le: bool = True) -> bytes:
    body = _Writer(version, data_le)
    _encode_group(body, tags)
    payload = body.buf.getvalue()
    head = _Writer(version, data_le)
    head.be("I", version)
    head.llong(len(payload))
    head.be("I", 1 if data_le else 0)
    return head.buf.getvalue() + payload


def make_image_tags(
    img: np.ndarray,
    scale: float = 1.0,
    units: str = "nm",
    name: str = "synthetic",
    operation_mode: str = "IMAGING",
    with_thumbnail: bool = True,
) -> dict[str, Any]:
    """Build an ImageList tag tree shaped like real Gatan files (thumbnail
    at entry 1, full image at entry 2 — the layout celltags assume)."""
    img = np.ascontiguousarray(img)
    dims: dict[str, Any] = {}
    for i, d in enumerate(reversed(img.shape)):  # x fastest
        dims[str(i + 1)] = np.uint32(d)

    def image_entry(arr: np.ndarray, dd: dict[str, Any]) -> dict[str, Any]:
        return {
            "Name": name,
            "ImageData": {
                "Calibrations": {
                    "Dimension": {
                        "1": {"Scale": np.float32(scale), "Units": units},
                    }
                },
                "Dimensions": dd,
                "Data": arr.reshape(-1),
            },
            "ImageTags": {
                "Microscope Info": {"Operation Mode": operation_mode},
            },
        }

    image_list: dict[str, Any] = {}
    if with_thumbnail:
        k = max(2, img.shape[-1] // 32)
        src2d = img if img.ndim == 2 else img[0]
        thumb = np.ascontiguousarray(src2d[::k, ::k].astype(np.float32))
        tdims = {str(i + 1): np.uint32(d) for i, d in enumerate(reversed(thumb.shape))}
        image_list["1"] = image_entry(thumb, tdims)
    image_list[str(len(image_list) + 1)] = image_entry(img, dims)
    return {"ImageList": image_list}


def write_dm(
    path: str,
    img: np.ndarray,
    version: int | None = None,
    data_le: bool = True,
    scale: float = 1.0,
    units: str = "nm",
    **kw: Any,
) -> None:
    if version is None:
        version = 4 if path.endswith(".dm4") else 3
    tags = make_image_tags(img, scale=scale, units=units, **kw)
    with open(path, "wb") as f:
        f.write(encode_dm(tags, version=version, data_le=data_le))

"""The subset of MessagePack that flax's `serialization.to_bytes` writes
and `msgpack_restore` reads, so the port reads and writes emx's
`params.msgpack` without the msgpack package.

Encoded as msgpack-python's `packb` does (smallest header for each
value, float64 floats, str and bin kept apart): maps, arrays, str, bin,
ints, floats, bool and nil, and flax's ext types 1 (an array: the
packed tuple (shape, dtype name, C-order bytes)) and 3 (a numpy scalar,
the same payload). bfloat16 arrays travel by name: they decode to
torch.bfloat16 tensors (numpy has no bfloat16), every other dtype to a
numpy array. Torch tensors encode as arrays of their dtype.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _head(out: bytearray, n: int, fix: int | None, fix_max: int,
          codes: tuple[int, int, int]) -> None:
    """A length header: fix | n when n fits, else the 8/16/32-bit form
    (codes[0] is None-like 0 for types without an 8-bit form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out += bytes((codes[1],)) + struct.pack(">H", n)
    else:
        out += bytes((codes[2],)) + struct.pack(">I", n)


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                out += bytes((code,)) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                out += bytes((code,)) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _array_payload(a) -> bytes:
    """flax's _ndarray_to_bytes: packb((shape, dtype name, bytes))."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = list(t.shape), "bfloat16"
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be packed")
        shape, name, raw = list(a.shape), a.dtype.name, a.tobytes("C")
    return packb([shape, name, raw])


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int) and not isinstance(v, np.generic):
        _int(out, v)
    elif isinstance(v, float):
        out += b"\xcb" + struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _head(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 15, (0, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 15, (0, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _ext(out, _EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(v)))
    else:
        raise TypeError(f"cannot pack {type(v).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _array_from_payload(data: bytes):
    shape, name, raw = unpackb(data)
    if name == "bfloat16":
        t = torch.frombuffer(bytearray(raw), dtype=torch.int16)
        return t.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(b)

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        code = self.num(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _array_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _array_from_payload(data)[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def value(self):
        c = self.num(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in fmts:
            return self.num(fmts[c])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(self.num(lens[c]))
        if c in (0xD9, 0xDA, 0xDB):
            return self.take(self.num(lens[c])).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(self.num(lens[c]))]
        if c in (0xDE, 0xDF):
            return self.map(self.num(lens[c]))
        if c in (0xC7, 0xC8, 0xC9):
            return self.ext(self.num(lens[c]))
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes):
    """Decode one msgpack value; trailing bytes are an error."""
    r = _Reader(data)
    v = r.value()
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the msgpack value")
    return v

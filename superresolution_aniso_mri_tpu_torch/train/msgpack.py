"""The part of MessagePack that flax checkpoints use, in plain Python.

``packb`` writes the bytes that ``flax.serialization.msgpack_serialize``
writes for the same tree (map keys sorted, msgpack's smallest
encodings); ``unpackb`` reads them back as
``flax.serialization.msgpack_restore`` does. Covered: maps, arrays
(lists and tuples), str, bin (bytes), int, float, bool and nil, plus
flax's extension types 1 (``np.ndarray``) and 3 (numpy scalar), each
packing ``(shape, dtype.name, C-order bytes)``. Anything else raises;
arrays over flax's 1 GiB chunk size are not written in chunks.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


def _head(out: bytearray, n: int, fix: int, fix_max: int,
          codes: Tuple[int, int, int]) -> None:
    """A length header: the fix form when ``n < fix_max``, else the 8-,
    16- or 32-bit form (``None`` code: no 8-bit form)."""
    if n < fix_max:
        out.append(fix | n)
    elif n < 1 << 8 and codes[0] is not None:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} too large")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: int {v} too small")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes((0xC7, n))
    elif n < 1 << 16:
        out.append(0xC8)
        out += struct.pack(">H", n)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "supported")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj: Any) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif t is str:
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif t is bytes:
        _head(out, len(obj), 0, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif t is dict:
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        # flax copies the tree with jax.tree_util first, which sorts keys
        for k in sorted(obj):
            _pack(out, k)
            _pack(out, obj[k])
    elif t in (list, tuple):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"msgpack: cannot serialize {t.__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {  # code → (kind, struct format of the length or value)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xCA: ("val", ">f"), 0xCB: ("val", ">d"),
    0xCC: ("val", ">B"), 0xCD: ("val", ">H"), 0xCE: ("val", ">I"),
    0xCF: ("val", ">Q"), 0xD0: ("val", ">b"), 0xD1: ("val", ">h"),
    0xD2: ("val", ">i"), 0xD3: ("val", ">q"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray_from(data: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not supported")
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from(data)[()]
    raise ValueError(f"msgpack: unsupported extension type {code}")


def _read(r: _Reader):
    c = r.take(1)[0]
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        return {_read(r): _read(r) for _ in range(c & 0x0F)}
    if 0x90 <= c <= 0x9F:
        return [_read(r) for _ in range(c & 0x0F)]
    if 0xA0 <= c <= 0xBF:
        return r.take(c & 0x1F).decode("utf-8")
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    if c in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[c]))
    if c not in _SIZED:
        raise ValueError(f"msgpack: unsupported type byte {c:#04x}")
    kind, fmt = _SIZED[c]
    n = r.unpack(fmt)
    if kind == "val":
        return n
    if kind == "bin":
        return r.take(n)
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "array":
        return [_read(r) for _ in range(n)]
    if kind == "map":
        return {_read(r): _read(r) for _ in range(n)}
    code = r.unpack(">b")
    return _ext(code, r.take(n))


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra bytes after the object")
    return obj

"""The part of MessagePack that flax checkpoints use, in plain Python.

``packb`` writes the bytes that ``flax.serialization.msgpack_serialize``
writes for the same tree (map keys sorted, msgpack's smallest
encodings); ``unpackb`` reads them back as
``flax.serialization.msgpack_restore`` does. Covered: maps, arrays
(lists and tuples), str, bin (bytes), int, float, bool and nil, plus
flax's extension types 1 (``np.ndarray``) and 3 (numpy scalar), each
packing ``(shape, dtype.name, C-order bytes)``. Anything else raises.

Flax's chunked arrays: an array of more than ``MAX_CHUNK_SIZE`` bytes
(flax's 1 GiB) that is a map value, or the whole tree, is written as
``{"__msgpack_chunked_array__": True, "shape": {"0": …}, "chunks":
{"0": flat chunk, …}}`` with ``MAX_CHUNK_SIZE // itemsize`` elements a
chunk; flax builds these maps after its sorted tree copy, so their keys
stay in insertion order. ``unpackb`` joins them back. ``pack_to``
streams the encoding to a writer, array data without a copy, so a
checkpoint of recipe-size VAE heads (two 4 GiB kernels) is not held
twice in host memory; ``unpackb``'s arrays view its input.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Optional, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNK_MARK = "__msgpack_chunked_array__"


class _Ordered(dict):
    """A map written in insertion order (flax's chunk maps)."""


def _chunk(arr: np.ndarray) -> _Ordered:
    """flax.serialization._chunk: the chunked form of ``arr``."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return _Ordered([
        (_CHUNK_MARK, True),
        ("shape", _Ordered((str(i), int(n)) for i, n in enumerate(arr.shape))),
        ("chunks", _Ordered((str(i), c) for i, c in enumerate(chunks)))])


def _maybe_chunked(v):
    if isinstance(v, np.ndarray) and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(v)
    return v


def _unchunk(tree):
    """flax.serialization._unchunk_array_leaves_in_place."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNK_MARK in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        if isinstance(v, dict):
            tree[k] = _unchunk(v)
    return tree


def _head(out: bytearray, n: int, fix: int, fix_max: int,
          codes: Tuple[Optional[int], int, int]) -> None:
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


def _ext_head(out: bytearray, code: int, n: int) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes((0xC7, n))
    elif n < 1 << 16:
        out.append(0xC8)
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(0xC9)
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack: extension of {n} bytes too large")
    out += struct.pack(">b", code)


class _Sink:
    """The encoding so far: small parts collect in ``buf``; array data
    of ``LARGE`` bytes or more goes to ``write`` as a view of the array
    (into ``buf`` when there is no writer)."""

    LARGE = 1 << 20

    def __init__(self, write: Optional[Callable] = None):
        self.buf = bytearray()
        self.write = write
        self.written = 0

    def data(self, view: memoryview) -> None:
        if self.write is None or view.nbytes < self.LARGE:
            self.buf += view
            return
        self.flush()
        self.write(view)
        self.written += view.nbytes

    def flush(self) -> None:
        if self.write is not None and self.buf:
            self.write(self.buf)
            self.written += len(self.buf)
            self.buf = bytearray()


def _pack_ndarray(w: _Sink, code: int, arr: np.ndarray) -> None:
    """Extension ``code`` holding the msgpack of ``(shape, dtype.name,
    C-order bytes)``, flax's ``_ndarray_to_bytes``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "supported")
    if not arr.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
        arr = np.ascontiguousarray(arr)
    prefix = bytearray((0x93,))
    _pack(prefix, list(arr.shape))
    _pack(prefix, arr.dtype.name)
    _head(prefix, arr.nbytes, 0, 0, (0xC4, 0xC5, 0xC6))
    _ext_head(w.buf, code, len(prefix) + arr.nbytes)
    w.buf += prefix
    w.data(memoryview(arr.reshape(-1)).cast("B"))


def _pack(w, obj: Any) -> None:
    """Encode ``obj`` into ``w``: a ``_Sink``, or a bytearray for the
    array-free headers of ``_pack_ndarray``."""
    out = w.buf if isinstance(w, _Sink) else w
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
    elif t in (dict, _Ordered):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        # flax copies the tree with jax.tree_util first, which sorts keys;
        # its chunk maps are made after the copy
        for k in (sorted(obj) if t is dict else obj):
            _pack(w, k)
            _pack(w, _maybe_chunked(obj[k]))
    elif t in (list, tuple):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(w, v)
    elif isinstance(obj, (np.ndarray, np.generic)):
        _pack_ndarray(w, EXT_NPSCALAR if isinstance(obj, np.generic)
                      else EXT_NDARRAY, np.asarray(obj))
    else:
        raise TypeError(f"msgpack: cannot serialize {t.__name__}")


def pack_to(write: Callable, obj: Any) -> int:
    """Stream the encoding of ``obj`` to ``write`` (e.g. a file's
    ``write``); returns the number of bytes written."""
    w = _Sink(write)
    _pack(w, _maybe_chunked(obj))
    w.flush()
    return w.written


def packb(obj: Any) -> bytes:
    w = _Sink()
    _pack(w, _maybe_chunked(obj))
    return bytes(w.buf)


class _Reader:
    def __init__(self, data, views: bool = False):
        self.data = memoryview(data).cast("B")
        self.pos = 0
        self.views = views  # bin payloads as views of ``data``

    def view(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def take(self, n: int) -> bytes:
        return self.view(n).tobytes()

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


def _ndarray_from(data) -> np.ndarray:
    shape, dtype, buf = _read(_Reader(data, views=True))
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not supported")
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _ext(code: int, data):
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
        return _ext(code, r.view(_FIXEXT[c]))
    if c not in _SIZED:
        raise ValueError(f"msgpack: unsupported type byte {c:#04x}")
    kind, fmt = _SIZED[c]
    n = r.unpack(fmt)
    if kind == "val":
        return n
    if kind == "bin":
        return r.view(n) if r.views else r.take(n)
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "array":
        return [_read(r) for _ in range(n)]
    if kind == "map":
        return {_read(r): _read(r) for _ in range(n)}
    code = r.unpack(">b")
    return _ext(code, r.view(n))


def unpackb(data) -> Any:
    """The tree of ``data`` (bytes or a buffer), chunked arrays joined;
    arrays view ``data``."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra bytes after the object")
    return _unchunk(obj)

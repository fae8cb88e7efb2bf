"""A small msgpack reader and writer for the native checkpoint format.

The native checkpoint is what ``flax.serialization.msgpack_serialize``
writes. The port imports neither flax nor the ``msgpack`` package, so this
module implements the part of the msgpack spec those files use (maps,
arrays, str, bin, nil, bool, ints, float32/64, ext) and flax's conventions
on top of it:

- an ndarray is ext code 1 whose payload is itself msgpack of
  ``(shape, dtype.name, raw C-order bytes)``;
- a numpy scalar is ext code 3 with the same payload (a 0-d array);
- an array leaf above 2**30 bytes is split into a dict
  ``{'__msgpack_chunked_array__': True, 'shape': {'0': ..}, 'chunks':
  {'0': .., '1': ..}}`` with string-digit keys, because msgpack caps one
  object at 2**31 - 1 bytes.

``packb`` writes ext 1 for arrays, ext 3 for numpy scalars, and chunks above
2**30 bytes; ``unpackb`` reads all of the above.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# The true limit is 2**31 - 1 bytes per object; flax leaves this margin.
# (A 1M x 128 fp32 entity table is 512 MB: under it, written as one leaf.)
MAX_CHUNK_SIZE = 2**30
_CHUNK_FLAG = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0 <= n:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack's uint64")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack's int64")


def _pack_len(n: int, out: list, fix: tuple[int, int] | None, codes: tuple) -> None:
    """Write a length header: ``fix`` is (base code, fix limit) or None;
    ``codes`` the (code, struct format, limit) ladder above it."""
    if fix is not None and n < fix[1]:
        out.append(bytes([fix[0] | n]))
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"object of {n} bytes/items is too large for msgpack")


def _pack_ext(code: int, payload: bytes, out: list) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n]]))
    else:
        _pack_len(n, out, None, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                                 (0xC9, ">I", 1 << 32)))
    out.append(struct.pack("b", code))
    out.append(payload)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out: list = []
    _pack((list(arr.shape), arr.dtype.name, arr.tobytes("C")), out)
    return b"".join(out)


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    return {
        _CHUNK_FLAG: True,
        "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
        "chunks": {str(i): flat[o:o + size]
                   for i, o in enumerate(range(0, flat.size, size))},
    }


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
        else:
            _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, (0xA0, 32), ((0xD9, ">B", 1 << 8),
                                              (0xDA, ">H", 1 << 16),
                                              (0xDB, ">I", 1 << 32)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), out, None, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                                        (0xC6, ">I", 1 << 32)))
        out.append(raw)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, (0x80, 16), ((0xDE, ">H", 1 << 16),
                                              (0xDF, ">I", 1 << 32)))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, (0x90, 16), ((0xDC, ">H", 1 << 16),
                                              (0xDD, ">I", 1 << 32)))
        for item in obj:
            _pack(item, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def packb(tree: Any) -> bytes:
    """A tree of dicts, lists, python scalars, str, bytes and numpy leaves ->
    msgpack bytes that ``flax.serialization.msgpack_restore`` reads."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # keep str objects as bytes (flax's ndarray payload)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.num("b")
        payload = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, dtype_name, buffer = _Reader(payload, raw=True).read()
            arr = np.frombuffer(buffer, dtype=_dtype_from_name(dtype_name))
            arr = arr.reshape(shape).copy()  # own, writable memory
            return arr[()] if code == EXT_NPSCALAR else arr
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self):
        b = self.num("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return self.array(b & 0x0F)
        if b < 0xC0:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in nums:
            return self.num(nums[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lens:  # bin: a view, so a large array's bytes are not copied twice
            return self.take(self.num(lens[b]))
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lens:
            return self.str_(self.num(lens[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.num(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.num(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        lens = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            return self.ext(self.num(lens[b]))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _dtype_from_name(name: bytes) -> np.dtype:
    if name == b"bfloat16":
        raise ValueError("bfloat16 leaves are not supported: numpy has no such dtype")
    return np.dtype(name.decode("ascii"))


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNK_FLAG in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """msgpack bytes written by ``packb`` or by
    ``flax.serialization.msgpack_serialize`` -> the tree, with ndarray leaves
    as writable numpy arrays, numpy scalars restored and chunked leaves
    rejoined. ``bin`` objects outside an array payload come back as bytes."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(_bytes_leaves(tree))


def _bytes_leaves(tree: Any) -> Any:
    if isinstance(tree, memoryview):
        return bytes(tree)
    if isinstance(tree, dict):
        return {k: _bytes_leaves(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bytes_leaves(v) for v in tree]
    return tree

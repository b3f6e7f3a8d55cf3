"""Flax's msgpack state-dict format, read and written in pure Python.

The JAX package saves checkpoints with `flax.serialization.to_bytes`
(`train/checkpoint.py`): a msgpack map of str keys whose leaves are
arrays, numpy scalars or nil. This module reads and writes the same bytes
without `flax` or `msgpack`:

- an ndarray is ext type 1 whose payload is itself msgpack, the array
  [shape, dtype name, raw C-order bytes];
- a numpy scalar is ext type 3 with the same payload (a 0-d array);
- `None` is nil; Python ints take msgpack's int forms.

Header forms covered: fix/16/32 maps and arrays, fix/8/16/32 str, 8/16/32
bin, fixext and ext 8/16/32, every int form, nil. Anything else (floats,
bools, other ext types, `__msgpack_chunked_array__` leaves, which flax
writes only past 2^30 bytes a leaf, a dtype that plain numpy cannot name
such as bfloat16) raises `ValueError` naming it. Leaves are written
straight from the array's buffer to the file and read by one copy out of
the file's bytes.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Mapping

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"
# the dtypes plain numpy names; flax writes `dtype.name`
DTYPE_NAMES = frozenset(
    ["bool", "float16", "float32", "float64", "complex64", "complex128"]
    + [f"{p}int{b}" for p in ("", "u") for b in (8, 16, 32, 64)])


# ---------------------------------------------------------------- writing

def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack("b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: int {v} does not fit 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, forms) -> bytes:
    """Header of a length-`n` object: a fix form below `fix_max`, else
    the first of `forms` ((code, struct format, limit)) that holds n."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in forms:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} is too long")


_L8, _L16, _L32 = 1 << 8, 1 << 16, 1 << 32


def _map(n: int) -> bytes:
    return _sized(n, 0x80, 16, ((0xDE, ">H", _L16), (0xDF, ">I", _L32)))


def _array(n: int) -> bytes:
    return _sized(n, 0x90, 16, ((0xDC, ">H", _L16), (0xDD, ">I", _L32)))


def _str(s: str) -> bytes:
    b = s.encode()
    return _sized(len(b), 0xA0, 32, ((0xD9, ">B", _L8), (0xDA, ">H", _L16),
                                     (0xDB, ">I", _L32))) + b


def _bin(n: int) -> bytes:
    return _sized(n, None, 0, ((0xC4, ">B", _L8), (0xC5, ">H", _L16),
                               (0xC6, ">I", _L32)))


def _ext(code: int, n: int) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _sized(n, None, 0, ((0xC7, ">B", _L8), (0xC8, ">H", _L16),
                                   (0xC9, ">I", _L32)))
    return head + struct.pack("b", code)


def _dtype_name(dtype: np.dtype) -> str:
    if dtype.name not in DTYPE_NAMES:
        raise ValueError(f"msgpack: dtype {dtype.name!r} has no plain numpy "
                         "name; flax's format cannot carry it here")
    return dtype.name


def _write_array(f: BinaryIO, arr: np.ndarray, code: int) -> None:
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    head = (_array(3) + _array(arr.ndim) + b"".join(_int(d) for d in arr.shape)
            + _str(_dtype_name(arr.dtype)) + _bin(arr.nbytes))
    f.write(_ext(code, len(head) + arr.nbytes))
    f.write(head)
    f.write(arr.reshape(-1).view(np.uint8).data)


def dump(tree, f: BinaryIO) -> None:
    """Write `tree` (nested str-keyed mappings of ndarrays, numpy scalars,
    ints and None) to the binary file `f`."""
    if isinstance(tree, Mapping):
        f.write(_map(len(tree)))
        for key, val in tree.items():
            if not isinstance(key, str):
                raise ValueError(f"msgpack: map key {key!r} is not a str")
            f.write(_str(key))
            dump(val, f)
    elif tree is None:
        f.write(b"\xc0")
    elif isinstance(tree, np.ndarray):
        _write_array(f, tree, EXT_NDARRAY)
    elif isinstance(tree, np.generic):
        _write_array(f, np.asarray(tree), EXT_NPSCALAR)
    elif isinstance(tree, int) and not isinstance(tree, bool):
        f.write(_int(tree))
    else:
        raise ValueError(f"msgpack: cannot write a {type(tree).__name__}")


def dumps(tree) -> bytes:
    """`tree` as bytes, the bytes `flax.serialization.to_bytes` gives."""
    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()


# ---------------------------------------------------------------- reading

_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_SINT = {0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


class _Reader:
    """One pass over a msgpack buffer. `views`: bin payloads come back as
    memoryviews into it (an array payload's data), else as bytes."""

    def __init__(self, buf, views: bool = False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.views = views

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _num(self, fmt: str) -> int:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self._take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in _UINT:
            return self._num(_UINT[b])
        if b in _SINT:
            return self._num(_SINT[b])
        if b in _STR:
            return str(self._take(self._num(_STR[b])), "utf-8")
        if b in _BIN:
            data = self._take(self._num(_BIN[b]))
            return data if self.views else bytes(data)
        if b in _ARRAY:
            return [self.obj() for _ in range(self._num(_ARRAY[b]))]
        if b in _MAP:
            return self._map(self._num(_MAP[b]))
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b in _EXT:
            return self._ext(self._num(_EXT[b]))
        raise ValueError(f"msgpack: unsupported header byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, str):
                raise ValueError(f"msgpack: map key {key!r} is not a str")
            if key == CHUNKED_KEY:
                raise ValueError(f"msgpack: a {CHUNKED_KEY} leaf (flax "
                                 "writes one past 2^30 bytes) is not "
                                 "supported")
            out[key] = self.obj()
        return out

    def _ext(self, n: int):
        code = struct.unpack("b", self._take(1))[0]
        payload = self._take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        inner = _Reader(payload, views=True)
        parts = inner.obj()
        if not (isinstance(parts, list) and len(parts) == 3):
            raise ValueError("msgpack: an array payload is not "
                             "[shape, dtype, data]")
        shape, name, data = parts
        name = str(name, "utf-8") if isinstance(name, memoryview) else name
        if name not in DTYPE_NAMES:
            raise ValueError(f"msgpack: dtype {name!r} has no plain numpy "
                             "name; it cannot be read without JAX")
        arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]


def loads(data) -> object:
    """Bytes in flax's format -> the tree (`flax.serialization.
    msgpack_restore`'s result: dicts, ndarrays, numpy scalars, None)."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: trailing bytes after the object")
    return out


def load(path: str) -> object:
    """The tree in the file at `path`."""
    with open(path, "rb") as f:
        return loads(f.read())

"""A pure-Python reader and writer of flax's msgpack tree format.

The JAX package saves parameter trees with ``flax.serialization.to_bytes``
(``models/persistence.py::save_model``): msgpack with every array leaf as
extension type 1, whose payload is itself msgpack, the array
``[shape, dtype name, C-order bytes]``. This module reads and writes that
format with numpy and the standard library alone, so that the port needs
neither flax nor msgpack.

Types: maps (str keys), str, bin, arrays, nil, bool, ints, floats, and the
extension types 1 (an ndarray) and 3 (a numpy scalar, stored as a rank-0
ndarray). numpy has no bfloat16, so a bf16 leaf is a :class:`Bfloat16`, which
holds the uint16 bits; :meth:`Bfloat16.to_float32` widens it by a 16-bit
shift (exact) and :func:`to_bfloat16` narrows f32 by round-to-nearest-even, as
``ml_dtypes``' ``astype(bfloat16)`` does.

The reader slices one ``memoryview`` of the input: arrays are read-only views
of the input buffer (as ``flax.serialization.msgpack_restore`` gives them),
not copies. The writer emits what ``msgpack.packb`` emits for the same tree:
the smallest header for each map, string, bin, int and extension, Python
floats as float64, and map keys in the order the dicts hold them.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


@dataclass(frozen=True)
class Bfloat16:
    """A bfloat16 array as its uint16 bit patterns (C order, ``bits.shape``)."""

    bits: np.ndarray

    @property
    def shape(self):
        return self.bits.shape

    def to_float32(self) -> np.ndarray:
        return (self.bits.astype(np.uint32) << 16).view(np.float32)


def to_bfloat16(x) -> Bfloat16:
    """f32 values rounded to bfloat16, to nearest with ties to even; a NaN
    becomes a quiet NaN of the same sign (``ml_dtypes``' rule)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) >> 16
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    quiet = np.where(bits >> 31, 0xFFC0, 0x7FC0)
    return Bfloat16(np.where(nan, quiet, rounded).astype(np.uint16))


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------
_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
# header byte -> (struct format of the fixed-width value)
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# header byte -> (struct format of the length, kind)
_SIZED = {
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf):
        self.view = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.view):
            raise ValueError("msgpack data ends inside an object")
        out = self.view[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        (value,) = struct.unpack_from(fmt, self.view, self.pos)
        self.pos += struct.calcsize(fmt)
        return value

    def read(self) -> Any:
        head = self.take(1)[0]
        if head <= 0x7F:
            return head
        if head >= 0xE0:
            return head - 0x100
        if 0x80 <= head <= 0x8F:
            return self.read_map(head & 0x0F)
        if 0x90 <= head <= 0x9F:
            return [self.read() for _ in range(head & 0x0F)]
        if 0xA0 <= head <= 0xBF:
            return str(self.take(head & 0x1F), "utf-8")
        if head in _FIXED:
            return _FIXED[head]
        if head in _NUMBERS:
            return self.unpack(_NUMBERS[head])
        if head in _FIXEXT:
            return self.read_ext(_FIXEXT[head])
        if head not in _SIZED:
            raise ValueError(f"msgpack header byte 0x{head:02x} is not supported")
        fmt, kind = _SIZED[head]
        n = self.unpack(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return self.read_map(n)
        return self.read_ext(n)

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not supported")
        shape, name, data = _Reader(payload).read()
        name = str(name, "utf-8") if isinstance(name, memoryview) else name
        if name == "bfloat16":
            leaf = Bfloat16(np.frombuffer(data, "<u2").reshape(shape))
            return leaf if code == EXT_NDARRAY else Bfloat16(leaf.bits[()])
        arr = np.frombuffer(data, np.dtype(name).newbyteorder("<")).reshape(shape)
        return arr if code == EXT_NDARRAY else arr[()]


def unpackb(buf) -> Any:
    """The tree encoded in ``buf`` (bytes or any buffer): dicts, lists, Python
    scalars, ``bytes``-like ``memoryview`` for bin, numpy arrays (read-only
    views of ``buf``) and :class:`Bfloat16` leaves."""
    reader = _Reader(buf)
    out = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError(f"{len(reader.view) - reader.pos} bytes after the msgpack object")
    return out


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------
def _header(out: bytearray, n: int, fix: int, fix_max: int, sized) -> None:
    """A length header: the fix form up to ``fix_max``, else the first of
    ``sized`` [(byte, struct format, max)] that holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for byte, fmt, most in sized:
        if n <= most:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"a msgpack object of length {n} is too long")


_B8, _B16, _B32 = 0xFF, 0xFFFF, 0xFFFFFFFF


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x <= 0x7F or -32 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
    elif x >= 0:
        for byte, fmt, most in ((0xCC, ">B", _B8), (0xCD, ">H", _B16), (0xCE, ">I", _B32),
                                (0xCF, ">Q", 2**64 - 1)):
            if x <= most:
                out.append(byte)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"{x} does not fit msgpack's uint64")
    else:
        for byte, fmt, least in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15), (0xD2, ">i", -2**31),
                                 (0xD3, ">q", -2**63)):
            if x >= least:
                out.append(byte)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"{x} does not fit msgpack's int64")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _header(out, n, None, 0, ((0xC7, ">B", _B8), (0xC8, ">H", _B16), (0xC9, ">I", _B32)))
    out += struct.pack(">b", code)
    out += payload


def _array_payload(shape, name: str, data: bytes) -> bytes:
    return packb([list(shape), name, data])


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 31, ((0xD9, ">B", _B8), (0xDA, ">H", _B16),
                                           (0xDB, ">I", _B32)))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), None, 0, ((0xC4, ">B", _B8), (0xC5, ">H", _B16),
                                          (0xC6, ">I", _B32)))
        out += data
    elif isinstance(obj, Mapping):
        _header(out, len(obj), 0x80, 15, ((0xDE, ">H", _B16), (0xDF, ">I", _B32)))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, not {type(key).__name__}")
            _pack(out, key)
            _pack(out, value)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, ((0xDC, ">H", _B16), (0xDD, ">I", _B32)))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, Bfloat16):
        bits = np.ascontiguousarray(obj.bits, dtype="<u2")
        _pack_ext(out, EXT_NDARRAY, _array_payload(bits.shape, "bfloat16", bits.tobytes()))
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.fields is not None:
            raise TypeError(f"arrays of dtype {obj.dtype} cannot be written")
        arr = obj.astype(obj.dtype.newbyteorder("<"), copy=False)
        _pack_ext(out, EXT_NDARRAY, _array_payload(arr.shape, arr.dtype.name,
                                                   arr.tobytes("C")))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        _pack_ext(out, EXT_NPSCALAR, _array_payload((), arr.dtype.name, arr.tobytes("C")))
    else:
        raise TypeError(f"cannot write a {type(obj).__name__} to msgpack")


def packb(tree: Any) -> bytes:
    """``tree`` encoded as flax's ``msgpack_serialize`` encodes it."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)

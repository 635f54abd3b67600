"""The flax-msgpack checkpoint format in plain Python (``struct`` and numpy).

The JAX package writes ``params.msgpack`` with ``flax.serialization.to_bytes``
and reads it with ``msgpack_restore``. This module is the port's own codec
for the same bytes, so checkpoints move between the packages on a machine
that has neither flax nor the ``msgpack`` package:

- ``unpackb`` / ``read_flax_msgpack``: maps, strings, bins, ints, floats,
  nil, bools, arrays and the ext types flax uses (1: ndarray, 2: complex,
  3: numpy scalar). An ndarray is ext 1 holding the msgpack array
  ``(shape, dtype name, C-order bytes)``; bf16 leaves widen to fp32 exactly.
  Leaves flax split into ``__msgpack_chunked_array__`` maps are reassembled.
- ``packb`` / ``write_flax_msgpack``: what ``to_bytes`` produces for a nested
  dict of numpy leaves, byte for byte: the smallest integer, length and ext
  encodings, Python floats as float64, keys as strings in insertion order,
  and leaves over ``MAX_CHUNK_SIZE`` bytes chunked as flax chunks them.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, NamedTuple

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An ext value of a type flax does not define, returned as read."""

    code: int
    data: bytes


# ---- reader ----------------------------------------------------------------


class _Reader:
    def __init__(self, buf: bytes, ext_hook, raw: bool,
                 bin_views: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.ext_hook = ext_hook
        self.raw = raw
        self.bin_views = bin_views  # bins as views of buf, not copies

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return self.ext_hook(code, self.take(n))

    def value(self):
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in sized:
            return self.unpack(sized[t])
        lengths = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= t <= 0xC6:  # bin 8/16/32
            data = self.take(self.unpack(lengths[t - 0xC4]))
            return data if self.bin_views else bytes(data)
        if 0xC7 <= t <= 0xC9:  # ext 8/16/32
            return self.ext(self.unpack(lengths[t - 0xC7]))
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (t - 0xD4))
        if 0xD9 <= t <= 0xDB:  # str 8/16/32
            return self.string(self.unpack(lengths[t - 0xD9]))
        if t in (0xDC, 0xDD):  # array 16/32
            n = self.unpack(">H" if t == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if t in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not defined")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _plain_ext(code: int, data) -> ExtType:
    return ExtType(code, bytes(data))


def unpackb(data: bytes, ext_hook=_plain_ext, raw: bool = False):
    """One msgpack value from ``data`` (``msgpack.unpackb`` for the types
    above); trailing bytes raise."""
    reader = _Reader(data, ext_hook, raw)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes of extra "
                         "data after the msgpack value")
    return out


def _ndarray_from_bytes(data) -> np.ndarray:
    """An ndarray ext payload -> a read-only array over ``data``'s memory
    (no copy, except bf16 widened to fp32)."""
    reader = _Reader(data, _plain_ext, raw=True, bin_views=True)
    shape, dtype_name, buffer = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("extra data after an ndarray payload")
    if dtype_name == b"bfloat16":  # widen bf16 bit patterns to fp32 exactly
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _flax_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        re_, im = unpackb(bytes(data))
        return complex(re_, im)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return ExtType(code, bytes(data))


def _unchunk(d):
    """Reassemble arrays that flax split into chunks."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
            chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in d.items()}
    return d


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the tree with numpy leaves."""
    return _unchunk(unpackb(data, ext_hook=_flax_ext))


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


# ---- writer ----------------------------------------------------------------


def _head(out: bytearray, n: int, fix_base: int, fix_max: int,
          codes: tuple):
    """A length header: the fix form below ``fix_max``, else the smallest of
    the 8/16/32-bit forms in ``codes`` (None where a width is not defined)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: bytearray, x: int):
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if x < limit:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} does not fit msgpack's uint64")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if x >= -limit:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} does not fit msgpack's int64")


def _pack_ext_header(out: bytearray, code: int, n: int):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)


def _pack_ext(out: bytearray, code: int, data: bytes):
    _pack_ext_header(out, code, len(data))
    out += data


class _Out(bytearray):
    """The bytes being written, with large raw buffers kept aside as views
    (``parts``), so an array's memory is not copied into the output."""

    RAW_MIN = 1 << 16

    def __init__(self):
        super().__init__()
        self.chunks = []

    def raw(self, buf: memoryview):
        if len(buf) < self.RAW_MIN:
            self += buf
            return
        self.chunks.append(bytes(self))
        self.clear()
        self.chunks.append(buf)

    def parts(self) -> list:
        return self.chunks + [bytes(self)]


def _pack_ndarray(out: bytearray, code: int, arr: np.ndarray):
    """An ndarray ext: the msgpack array ``(shape, dtype name, C-order
    bytes)``, the bytes passed to ``out.raw`` when ``out`` takes views."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    head = bytearray()
    # shape as a list: the inner pack is flax's non-strict one
    _pack(head, [list(arr.shape), arr.dtype.name])
    head[0] = 0x93  # the array holds three items: the bytes follow
    _head(head, arr.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
    _pack_ext_header(out, code, len(head) + arr.nbytes)
    out += head
    data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    if isinstance(out, _Out):
        out.raw(data)
    else:
        out += data


def _pack(out: bytearray, x):
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _head(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif type(x) is bytes:
        _head(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif type(x) is dict:
        _head(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif type(x) is list:
        _head(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        _pack_ndarray(out, _EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        _pack_ndarray(out, _EXT_NPSCALAR, np.asarray(x))
    elif type(x) is complex:
        _pack_ext(out, _EXT_COMPLEX, packb([x.real, x.imag]))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} to msgpack")


def packb(x) -> bytes:
    """``x`` as msgpack bytes (``msgpack.packb`` for the types above)."""
    out = bytearray()
    _pack(out, x)
    return bytes(out)


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): n for i, n in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in
                       enumerate(range(0, flat.size, size))}}


def _state_dict(x):
    """flax's ``to_state_dict`` and leaf chunking for dicts of arrays."""
    if isinstance(x, dict):
        return {str(k): _state_dict(v) for k, v in x.items()}
    if isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def _parts(tree) -> list:
    out = _Out()
    _pack(out, _state_dict(tree))
    return out.parts()


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a nested dict of numpy leaves."""
    return b"".join(_parts(tree))


def write_flax_msgpack(tree, path: str):
    """``to_bytes(tree)`` written to ``path``, the arrays' memory written
    from where it lies."""
    with open(path, "wb") as f:
        f.writelines(_parts(tree))

"""flax's checkpoint bytes, read and written without flax or msgpack.

``flax.serialization.to_bytes`` of a parameter tree (nested dicts of arrays)
is msgpack: a map per dict, in the dict's insertion order, and each array as
msgpack extension type 1, whose payload is itself msgpack of the triple
(shape, dtype name, C-order bytes); a numpy scalar is extension type 3 with
the same payload. An array above ``MAX_CHUNK_SIZE`` bytes is first replaced by
a map ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
"chunks": {"0": flat part, ...}}``. ``to_bytes`` writes those bytes exactly as
flax does for such a tree (the same encoding choices as msgpack-python's
packer: the smallest int, str, bin, map, array and ext headers, doubles for
floats); ``from_bytes`` reads them back into nested dicts of numpy arrays,
chunked arrays joined.
"""

from __future__ import annotations

import struct

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax's limit per chunk (msgpack's is 2**31 - 1 bytes per object)
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ encoding
def _header(out, n, small_base, small_max, codes):
    """A length header: the one-byte form below ``small_max``, else the
    smallest of the 8- (where ``codes`` has one), 16- and 32-bit forms."""
    if small_base is not None and n < small_max:
        out.append(bytes([small_base | n]))
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out, x):
    if 0 <= x < 128:
        out.append(bytes([x]))
    elif -32 <= x < 0:
        out.append(bytes([x & 0xFF]))
    elif x >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if x < limit:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(x)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if x >= -limit:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(x)


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _header(out, n, None, 0, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32)))
        out.append(bytes([code]))
    out.append(data)


def _ndarray_payload(arr):
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    out = []
    _pack(out, (tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))
    return b"".join(out)


def _pack(out, x):
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _header(out, len(data), 0xA0, 32, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32)))
        out.append(data)
    elif isinstance(x, (bytes, bytearray)):
        _header(out, len(x), None, 0, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32)))
        out.append(bytes(x))
    elif isinstance(x, dict):
        _header(out, len(x), 0x80, 16, ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))
        for key, value in x.items():
            _pack(out, key)
            _pack(out, value)
    elif isinstance(x, (list, tuple)):
        _header(out, len(x), 0x90, 16, ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))
        for value in x:
            _pack(out, value)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _chunk(arr):
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i : i + chunksize] for i in range(0, flat.size, chunksize)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunked(tree):
    if isinstance(tree, dict):
        return {str(k): _chunked(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of dicts and numpy arrays."""
    out = []
    _pack(out, _chunked(tree))
    return b"".join(out)


# ------------------------------------------------------------------ decoding
class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos : self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
            0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _ndarray_from_payload(data):
    shape, dtype_name, buffer = _read(_Reader(data))
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(bytes(buffer), dtype=np.dtype(dtype_name)).reshape(shape, order="C")


def _ext(code, data):
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    raise ValueError(f"unknown msgpack extension type {code}")


def _read(r):
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b in _LENGTHS:
        n = r.unpack(_LENGTHS[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            code = r.unpack(">b")
            return _ext(code, r.take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return str(r.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return [_read(r) for _ in range(n)]
        return _read_map(r, n)
    raise ValueError(f"unsupported msgpack byte 0x{b:02x}")


def _read_map(r, n):
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def _unchunked(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            return np.concatenate([tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]).reshape(shape)
        return {k: _unchunked(v) for k, v in tree.items()}
    return tree


def from_bytes(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` reads from ``data``."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunked(tree)

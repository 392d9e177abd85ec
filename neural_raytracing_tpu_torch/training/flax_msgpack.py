"""A small pure-Python reader and writer of flax's msgpack pytree format.

The JAX package writes its scene artifacts with
``flax.serialization.to_bytes``: a msgpack map of string keys (tuples become
maps keyed "0", "1", ...), each array an extension of type 1 whose payload is
the msgpack array ``[shape, dtype name, C-order bytes]`` (type 3: a numpy
scalar, same payload).  This module reads and writes that format with numpy
and the standard library alone, so the port and the JAX package exchange
scene artifacts.  Supported: maps, arrays, strings, binary, integers, floats,
booleans, nil, and the two array extensions (arrays above flax's 1 GiB chunk
limit are not).
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ---- reading ----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self, raw: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, raw)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lengths:
            return self.str(self.unpack(lengths[b]), raw)
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"), raw)
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int, raw: bool):
        s = bytes(self.take(n))
        return s if raw else s.decode("utf-8")

    def array(self, n: int, raw: bool) -> list:
        return [self.value(raw) for _ in range(n)]

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out


def _ext(code: int, payload: memoryview):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack extension type {code}")
    shape, dtype, buf = _Reader(bytes(payload)).value(raw=True)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
    return arr[()] if code == EXT_NPSCALAR else arr


def restore(data: bytes):
    """Decode flax msgpack bytes to nested dicts of numpy arrays (as
    ``flax.serialization.msgpack_restore`` does)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


# ---- writing ----------------------------------------------------------------

def _pack_len(out: list, n: int, fix_base, fix_max, codes):
    if fix_base is not None and n <= fix_max:
        out.append(bytes([fix_base | n]))
    elif n < 1 << 8 and codes[0] is not None:
        out.append(bytes([codes[0]]) + struct.pack(">B", n))
    elif n < 1 << 16:
        out.append(bytes([codes[1]]) + struct.pack(">H", n))
    else:
        out.append(bytes([codes[2]]) + struct.pack(">I", n))


def _pack(out: list, x):
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, (bool, np.bool_)) and not isinstance(x, np.ndarray):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        if 0 <= x <= 0x7F:
            out.append(bytes([x]))
        elif -32 <= x < 0:
            out.append(struct.pack(">b", x))
        elif x >= 0:
            for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if x < top:
                    out.append(bytes([code]) + struct.pack(fmt, x))
                    break
        else:
            for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                                    (0xD2, ">i", 31), (0xD3, ">q", 63)):
                if x >= -(1 << bits):
                    out.append(bytes([code]) + struct.pack(fmt, x))
                    break
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        s = x.encode("utf-8")
        _pack_len(out, len(s), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(s)
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), None, -1, (0xC4, 0xC5, 0xC6))
        out.append(bytes(x))
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        payload = []
        _pack(payload, [list(arr.shape), arr.dtype.name, arr.tobytes(order="C")])
        body = b"".join(payload)
        code = EXT_NPSCALAR if isinstance(x, np.generic) else EXT_NDARRAY
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(body) in fixed:
            out.append(bytes([fixed[len(body)]]) + struct.pack(">b", code))
        else:
            _pack_len(out, len(body), None, -1, (0xC7, 0xC8, 0xC9))
            out.append(struct.pack(">b", code))
        out.append(body)
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


def serialize(tree) -> bytes:
    """Encode nested dicts (string keys) of numpy arrays the way
    ``flax.serialization.to_bytes`` does."""
    out: list = []
    _pack(out, tree)
    return b"".join(out)

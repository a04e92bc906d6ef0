"""Reader of the msgpack that flax's ``serialization.msgpack_serialize``
writes (the JAX package's checkpoints), in pure Python over numpy.

Reads maps, arrays, str, bin, ints, floats, nil and bool, and flax's two
ndarray ext records: code 1, an array, and code 3, a numpy scalar, each
holding a msgpack ``(shape, dtype name, buffer)`` triple.  Any other ext
code raises.  Arrays come back read-only over the file's bytes, as
``flax.serialization.msgpack_restore`` gives them.  (flax splits a leaf over
1 GiB into chunks; no checkpoint of this repo has one, and they come back
here as flax's chunk dicts.)  Neither the port nor the card needs
``msgpack`` or ``flax`` for it.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
# type byte → (struct format, byte count) of a fixed-width number
_NUMBERS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
            0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
            0xD2: (">i", 4), 0xD3: (">q", 8)}
_LENGTHS = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return struct.unpack(_LENGTHS[n], self.take(n))[0]

    def value(self, raw: bool = False):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F, raw)
        if 0x90 <= t <= 0x9F:
            return [self.value(raw) for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F, raw)
        if t in _FIXED:
            return _FIXED[t]
        if t in _NUMBERS:
            fmt, n = _NUMBERS[t]
            return struct.unpack(fmt, self.take(n))[0]
        if 0xC4 <= t <= 0xC6:  # bin 8/16/32
            return self.take(self.uint(1 << (t - 0xC4))).tobytes()
        if 0xD9 <= t <= 0xDB:  # str 8/16/32
            return self.str(self.uint(1 << (t - 0xD9)), raw)
        if t in (0xDC, 0xDD):  # array 16/32
            return [self.value(raw) for _ in range(self.uint(2 if t == 0xDC else 4))]
        if t in (0xDE, 0xDF):  # map 16/32
            return self.map(self.uint(2 if t == 0xDE else 4), raw)
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (t - 0xD4))
        if 0xC7 <= t <= 0xC9:  # ext 8/16/32
            return self.ext(self.uint(1 << (t - 0xC7)))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not read here")

    def str(self, n: int, raw: bool):
        b = self.take(n).tobytes()
        return b if raw else b.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext code {code} is not a flax ndarray record")
        # flax unpacks the triple with raw=True: the dtype name is bytes.
        inner = _Reader(data)
        shape, name, buffer = inner.value(raw=True)
        arr = np.frombuffer(buffer, dtype=np.dtype(name.decode())).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def loads(data: bytes):
    """Decode flax msgpack bytes → nested dicts with numpy leaves, as
    ``flax.serialization.msgpack_restore`` does."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes after the msgpack value")
    return tree


def load(path: str):
    """:func:`loads` of a file."""
    with open(path, "rb") as f:
        return loads(f.read())

"""The event log's record stream, in pure Python.

The wire format of ``native/trajlog.cpp`` (and of the JAX package's
``utils/native.py``, whose pure-Python paths these functions follow):

    file   := magic (u32 little-endian 0x54524A4C, 'TRJL') record*
    record := length (u32 little-endian) payload

A writer appends to an existing stream and writes the magic only into an
empty file, so logs from either package and either codec read alike.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

MAGIC = 0x54524A4C
_U32 = struct.Struct("<I")


class RecordWriter:
    """Append-only length-prefixed record stream."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "ab")
        if self._f.tell() == 0:
            self._f.write(_U32.pack(MAGIC))

    def write(self, payload: bytes) -> None:
        self._f.write(_U32.pack(len(payload)))
        self._f.write(payload)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _check_magic(f, path: str) -> None:
    magic = f.read(4)
    if len(magic) < 4 or _U32.unpack(magic)[0] != MAGIC:
        raise IOError(f"not a trajlog file: {path!r}")


def read_records(path: str) -> Iterator[bytes]:
    """Stream the records back; a truncated tail raises IOError."""
    with open(path, "rb") as f:
        _check_magic(f, path)
        while True:
            header = f.read(4)
            if not header:
                return
            if len(header) < 4:
                raise IOError("truncated record")
            (n,) = _U32.unpack(header)
            data = f.read(n)
            if len(data) < n:
                raise IOError("truncated record")
            yield data


def scan_records(path: str) -> list[int]:
    """Byte offset of every record header, reading headers only; a
    truncated tail (a writer that died mid-record) raises IOError."""
    offsets = []
    with open(path, "rb") as f:
        _check_magic(f, path)
        size = f.seek(0, os.SEEK_END)
        off = 4
        while off < size:
            if size - off < 4:
                raise IOError("truncated record header")
            f.seek(off)
            (n,) = _U32.unpack(f.read(4))
            if size - off - 4 < n:
                raise IOError("truncated record payload")
            offsets.append(off)
            off += 4 + n
    return offsets


def read_record_at(path: str, offset: int) -> bytes:
    """The one record whose header starts at ``offset`` (from
    :func:`scan_records`)."""
    with open(path, "rb") as f:
        f.seek(offset)
        (n,) = _U32.unpack(f.read(4))
        data = f.read(n)
        if len(data) < n:
            raise IOError("truncated record")
        return data

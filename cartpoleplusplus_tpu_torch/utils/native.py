"""The event log's record codec in C++, bound by ctypes: port of
cartpoleplusplus_tpu.utils.native.

``native/trajlog.cpp`` (at the repository root, beside both packages) is a
buffered writer and reader of the record stream :mod:`utils.records`
describes.  It is compiled with ``g++ -O2 -shared -fPIC`` at first use into
``_build/trajlog-<hash of the source and flags>/libtrajlog.so`` beside this
package's kernel library, never into ``native/``.  Where no compiler is
found, or the source is missing, every function runs the pure-Python codec
of :mod:`utils.records` instead (as the JAX module does); ``force_python``
asks for it.  Both write the same bytes, so either reads what the other
wrote, and so do the JAX package's codecs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Iterator, Optional

from cartpoleplusplus_tpu_torch.utils import records

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "trajlog.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libtrajlog.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-Wall")
CXX_TIMEOUT_S = 120

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
# What the first load did: the library's path, whether it was compiled and
# how long that took, or why the native codec is unavailable.
BUILD_INFO: dict = {}


def lib_dir() -> str:
    """The build directory of the current source and flags."""
    h = hashlib.sha256(repr(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"trajlog-{h.hexdigest()[:16]}")


def build() -> dict:
    """Compile the library unless this source's build exists → ``{"path",
    "built", "cxx_s"}``.  The compile writes into a temporary directory
    under ``_build/`` and renames the library into place, so processes
    that build at once each see a whole file."""
    out_dir = lib_dir()
    path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(path):
        return {"path": path, "built": False, "cxx_s": 0.0}
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) found")
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-")
    try:
        t0 = time.monotonic()
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", os.path.join(tmp, LIB_NAME), SOURCE],
                              capture_output=True, text=True, timeout=CXX_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
        cxx_s = time.monotonic() - t0
        os.makedirs(out_dir, exist_ok=True)
        os.replace(os.path.join(tmp, LIB_NAME), path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"path": path, "built": True, "cxx_s": cxx_s}


def _load_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built first if needed); None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        BUILD_INFO.update(build())
        lib = ctypes.CDLL(BUILD_INFO["path"])
    except Exception as exc:
        BUILD_INFO["error"] = f"{type(exc).__name__}: {exc}"
        return None
    ptr, u64, i64, cstr = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_char_p
    for name, restype, argtypes in (
            ("tl_open", ptr, [cstr]),
            ("tl_write", ctypes.c_int, [ptr, cstr, u64]),
            ("tl_flush", ctypes.c_int, [ptr]),
            ("tl_close", None, [ptr]),
            ("tl_reader_open", ptr, [cstr]),
            ("tl_next_len", i64, [ptr]),
            ("tl_read", i64, [ptr, cstr, u64]),
            ("tl_reader_close", None, [ptr]),
            ("tl_scan", i64, [cstr, ctypes.POINTER(u64), i64]),
            ("tl_read_at", i64, [cstr, u64, cstr, u64])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


class RecordWriter:
    """Append-only length-prefixed record stream (native when possible)."""

    def __init__(self, path: str, force_python: bool = False):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lib = None if force_python else _load_lib()
        if self._lib is None:
            self._py = records.RecordWriter(path)
            return
        self._h = self._lib.tl_open(path.encode())
        if not self._h:
            raise IOError(f"tl_open failed for {path!r}")

    def write(self, payload: bytes) -> None:
        if self._lib is None:
            return self._py.write(payload)
        rc = self._lib.tl_write(self._h, payload, len(payload))
        if rc != 0:
            raise IOError(f"tl_write rc={rc}")

    def flush(self) -> None:
        if self._lib is None:
            return self._py.flush()
        self._lib.tl_flush(self._h)

    def close(self) -> None:
        if self._lib is None:
            return self._py.close()
        if self._h:
            self._lib.tl_close(self._h)
            self._h = None


def read_records(path: str, force_python: bool = False) -> Iterator[bytes]:
    """Stream the records back; a bad magic or a truncated tail raises
    IOError."""
    lib = None if force_python else _load_lib()
    if lib is None:
        yield from records.read_records(path)
        return
    h = lib.tl_reader_open(path.encode())
    if not h:
        raise IOError(f"not a trajlog file: {path!r}")
    try:
        while True:
            n = lib.tl_next_len(h)
            if n == -9:  # clean end of file
                return
            if n < 0:
                raise IOError(f"tl_next_len rc={n}")
            buf = ctypes.create_string_buffer(max(int(n), 1))
            got = lib.tl_read(h, buf, max(int(n), 1))
            if got != n:
                raise IOError(f"tl_read rc={got}")
            yield buf.raw[:int(n)]
    finally:
        lib.tl_reader_close(h)


def scan_records(path: str, force_python: bool = False) -> list[int]:
    """Byte offset of every record header, reading headers only; a
    truncated tail raises IOError."""
    lib = None if force_python else _load_lib()
    if lib is None:
        return records.scan_records(path)
    count = lib.tl_scan(path.encode(), None, 0)
    if count < 0:
        raise IOError(f"tl_scan rc={count} for {path!r}")
    arr = (ctypes.c_uint64 * max(int(count), 1))()
    got = lib.tl_scan(path.encode(), arr, count)
    if got != count:
        raise IOError(f"tl_scan changed underfoot: {got} != {count}")
    return [int(arr[i]) for i in range(int(count))]


def read_record_at(path: str, offset: int, force_python: bool = False) -> bytes:
    """The one record whose header starts at ``offset`` (from
    :func:`scan_records`)."""
    lib = None if force_python else _load_lib()
    if lib is None:
        return records.read_record_at(path, offset)
    n = lib.tl_read_at(path.encode(), offset, None, 0)
    if n < 0:
        raise IOError(f"tl_read_at rc={n}")
    buf = ctypes.create_string_buffer(max(int(n), 1))
    got = lib.tl_read_at(path.encode(), offset, buf, n)
    if got != n:
        raise IOError(f"tl_read_at rc={got}")
    return buf.raw[:int(n)]

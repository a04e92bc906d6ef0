"""The port's trajlog codec (``utils/native.py``: ``native/trajlog.cpp`` by
ctypes, the pure-Python paths of ``utils/records.py`` beside it) in the
eight cases of the JAX package's tests/test_native.py, and against the JAX
codec: every writer of either package, native or Python, writes the same
bytes, and every reader reads every writer's file."""

import itertools
import os
import shutil
import struct

import numpy as np
import pytest

from cartpoleplusplus_tpu.utils import native as jnative
from cartpoleplusplus_tpu_torch.utils import event_log as el
from cartpoleplusplus_tpu_torch.utils.native import (
    RecordWriter, native_available, read_record_at, read_records, scan_records)

PAYLOADS = [b"", b"x", b"hello world", os.urandom(1 << 16), os.urandom(5 << 20)]


def _roundtrip(tmp_path, force_write_py, force_read_py):
    path = str(tmp_path / f"t_{force_write_py}_{force_read_py}.log")
    w = RecordWriter(path, force_python=force_write_py)
    for p in PAYLOADS:
        w.write(p)
    w.close()
    assert list(read_records(path, force_python=force_read_py)) == PAYLOADS


def test_python_roundtrip(tmp_path):
    _roundtrip(tmp_path, True, True)


@pytest.mark.skipif(not native_available(), reason="no C++ toolchain")
def test_native_roundtrip(tmp_path):
    _roundtrip(tmp_path, False, False)


@pytest.mark.skipif(not native_available(), reason="no C++ toolchain")
def test_cross_compat_wire_format(tmp_path):
    _roundtrip(tmp_path, False, True)
    _roundtrip(tmp_path, True, False)


@pytest.mark.skipif(not native_available(), reason="no C++ toolchain")
def test_append_reopen(tmp_path):
    path = str(tmp_path / "append.log")
    for payload in (b"one", b"two"):
        w = RecordWriter(path)
        w.write(payload)
        w.close()
    assert list(read_records(path)) == [b"one", b"two"]


@pytest.mark.parametrize("force_python", [True, False])
def test_reader_rejects_garbage(tmp_path, force_python):
    path = str(tmp_path / "garbage.bin")
    with open(path, "wb") as f:
        f.write(b"notatrajlogfile")
    with pytest.raises(IOError):
        list(read_records(path, force_python=force_python))


def test_scan_records_native_and_python(tmp_path):
    """Both backends index every record alike; ``read_record_at`` returns
    each payload by its offset."""
    path = str(tmp_path / "scan.trjl")
    payloads = [b"", b"a", b"hello" * 100, bytes(range(256))]
    w = RecordWriter(path)
    for p in payloads:
        w.write(p)
    w.close()
    offs_py = scan_records(path, force_python=True)
    assert len(offs_py) == len(payloads)
    assert scan_records(path) == offs_py
    for off, expect in zip(offs_py, payloads):
        assert read_record_at(path, off, force_python=True) == expect
        assert read_record_at(path, off) == expect


def test_scan_records_detects_truncated_tail(tmp_path):
    """A writer that died mid-record fails the scan in both backends."""
    path = str(tmp_path / "trunc.trjl")
    w = RecordWriter(path)
    w.write(b"complete record")
    w.close()
    with open(path, "ab") as f:
        f.write(struct.pack("<I", 1000))
        f.write(b"only a few")
    for force_python in (True, False):
        with pytest.raises(IOError):
            scan_records(path, force_python=force_python)


def test_event_log_episode_selection(tmp_path):
    """``--episode N`` decodes exactly one episode through the index."""
    path = str(tmp_path / "ep.log")
    log = el.EventLog(path)
    for k in range(3):
        pose = np.full((7,), float(k), np.float32)
        log.add_episode([el.make_event(pose, pose, [0.0, 0.0], 1.0, False)
                         for _ in range(2 + k)])
    log.close()
    offsets = el.index_event_log(path)
    assert len(offsets) == 3
    ep1 = el.read_episode_at(path, offsets[1])
    assert len(ep1.event) == 3
    assert abs(ep1.event[0].cart.position[0] - 1.0) < 1e-6


WRITERS = {"port_native": lambda p: RecordWriter(p),
           "port_python": lambda p: RecordWriter(p, force_python=True),
           "jax_native": lambda p: jnative.RecordWriter(p),
           "jax_python": lambda p: jnative.RecordWriter(p, force_python=True)}
READERS = {"port_native": lambda p: list(read_records(p)),
           "port_python": lambda p: list(read_records(p, force_python=True)),
           "jax_native": lambda p: list(jnative.read_records(p)),
           "jax_python": lambda p: list(jnative.read_records(p, force_python=True))}


def _build_jax_codec_apart(tmp_path, monkeypatch) -> str:
    """Point the JAX codec's loader at a copy of ``native/``'s source and
    Makefile under ``tmp_path`` and clear its per-process cache (both put
    back after the test) → the copy's directory."""
    build = tmp_path / "jax_native"
    build.mkdir()
    for name in ("trajlog.cpp", "Makefile"):
        shutil.copy2(os.path.join(jnative._native_dir, name), build / name)
    monkeypatch.setattr(jnative, "_native_dir", str(build))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_tried", False)
    return str(build)


@pytest.fixture
def jax_codec_built_apart(tmp_path, monkeypatch):
    """The JAX codec built where no other process writes.  Every xdist
    worker that collects ``tests/test_native.py`` calls the JAX loader,
    which runs ``make`` into the shared ``native/libtrajlog.so`` when that
    file is absent and caches a failed load for the process; a worker could
    load a file another was still writing.  Built apart, the same source
    and the same loader make a library no other process writes."""
    _build_jax_codec_apart(tmp_path, monkeypatch)


def test_jax_codec_built_apart_after_a_failed_load(tmp_path, monkeypatch):
    """A failed load, as a race with another worker's build leaves it, is
    cached by the JAX loader for the process; built apart, the codec loads
    all the same, from the test's own directory."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_tried", True)
    assert not jnative.native_available()
    build = _build_jax_codec_apart(tmp_path, monkeypatch)
    assert jnative.native_available()
    assert os.path.exists(os.path.join(build, "libtrajlog.so"))


@pytest.mark.usefixtures("jax_codec_built_apart")
def test_files_equal_across_packages_and_codecs(tmp_path):
    """The same records, appended in two sessions, by each of the four
    writers: four byte-equal files, each read back whole by all four
    readers and indexed alike by both packages' scans."""
    assert native_available() and jnative.native_available()
    files = {}
    for name, make in WRITERS.items():
        path = str(tmp_path / f"{name}.log")
        for part in (PAYLOADS[:3], PAYLOADS[3:]):
            w = make(path)
            for p in part:
                w.write(p)
            w.close()
        with open(path, "rb") as f:
            files[name] = (path, f.read())
    blobs = {blob for _, blob in files.values()}
    assert len(blobs) == 1
    for (path, _), (reader, read) in itertools.product(files.values(), READERS.items()):
        assert read(path) == PAYLOADS, (path, reader)
    offsets = scan_records(files["jax_native"][0])
    assert offsets == jnative.scan_records(files["port_native"][0]) == scan_records(
        files["port_python"][0], force_python=True)
    assert read_record_at(files["jax_python"][0], offsets[3]) == PAYLOADS[3]

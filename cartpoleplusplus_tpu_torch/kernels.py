"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with plain ``nvcc`` for sm_90a
into ``libcartpole_kernels.so``, a shared library with a C interface loaded
through ctypes; it never includes PyTorch's headers.  The library lives in
``_build/<hash of the sources and flags>/`` beside this file, built at first
use and rebuilt whenever a source changes.  Each source is compiled by its
own ``nvcc`` process, all started together, then linked; each ``nvcc``
is killed after ``NVCC_TIMEOUT_S``.  A file lock in ``_build/`` lets one
process build while the others (data-parallel ranks) wait and load.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")
LIB_NAME = "libcartpole_kernels.so"
LOG_NAME = "build.log"
NVCC_TIMEOUT_S = 180

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Per-source extra flags.  physics.cu is built without FMA contraction: its
# results must match the plain PyTorch version (which rounds every multiply
# and add) to 1e-5 after 30 substeps, and with contracted FMAs the pole's
# spin drifted past that bound.
SOURCES = {
    "physics.cu": ("-fmad=false",),
    "render.cu": (),
    "roofline.cu": (),
}

# Launches per wrapper, by kernel name.
LAUNCHES = {
    "step_repeats": 0,                     # K1
    "step_substeps": 0,                    # K2
    "render_repeats": 0,                   # K3 (slab mode)
    "render_batched": 0,                   # K4 (slab mode)
    "render_repeats_raster": 0,            # K5a through K3's launch
    "render_batched_raster": 0,            # K5a through K4's launch
    "render_repeats_ratio": 0,             # K5b through K3's launch
    "render_batched_ratio": 0,             # K5b through K4's launch
    "pack_setups": 0,                      # K5c's setup pass, both launches
    "render_repeats_raster_hoist": 0,      # K5c through K3's launch
    "render_batched_raster_hoist": 0,      # K5c through K4's launch
    "render_repeats_raster_mxu": 0,        # K5d through K3's launch
    "render_batched_raster_mxu": 0,        # K5d through K4's launch
    "render_repeats_raster_hoist_mxu": 0,  # K5d from K5c's table, K3's launch
    "render_batched_raster_hoist_mxu": 0,  # K5d from K5c's table, K4's launch
    # K6, one count per op chain
    **{f"roofline_{mix}": 0 for mix in ("fma_f32", "fma_bf16", "mix_f32", "mix_bf16",
                                        "recip_f32", "div_f32")},
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def source_hash() -> str:
    """Hash of every source and of the compiler flags."""
    h = hashlib.sha256()
    h.update(repr((ARCH_FLAGS, COMMON_FLAGS, sorted(SOURCES.items()))).encode())
    for name in sorted(SOURCES):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc_run(cmd: list[str]) -> str:
    """Run one nvcc command, killed after NVCC_TIMEOUT_S → its output."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> dict:
    """Compile the library if the sources changed → build info.

    Returns ``{"path", "built", "nvcc_s", "log"}``: ``built`` is False when
    an up-to-date library was found, ``nvcc_s`` the wall time of the
    compile and link (0 when nothing was built), ``log`` the compilers'
    output (kept beside the library, so also when it was found built).
    """
    os.makedirs(BUILD_ROOT, exist_ok=True)
    with open(os.path.join(BUILD_ROOT, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked()


def _build_locked() -> dict:
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, LOG_NAME)
    if os.path.exists(lib_path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return {"path": lib_path, "built": False, "nvcc_s": 0.0, "log": log}
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-")
    try:
        t0 = time.monotonic()
        objs, compiles = [], []
        for name, extra in SOURCES.items():
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            objs.append(obj)
            compiles.append([nvcc, *ARCH_FLAGS, *COMMON_FLAGS, *extra, "-c",
                             os.path.join(CSRC, name), "-o", obj])
        with ThreadPoolExecutor(len(compiles)) as pool:
            logs = list(pool.map(_nvcc_run, compiles))
        logs.append(_nvcc_run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", os.path.join(tmp, LIB_NAME), *objs]))
        nvcc_s = time.monotonic() - t0
        os.makedirs(out_dir, exist_ok=True)
        with open(log_path, "w") as f:
            f.write("".join(logs))
        os.replace(os.path.join(tmp, LIB_NAME), lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"path": lib_path, "built": True, "nvcc_s": nvcc_s, "log": "".join(logs)}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), argtypes set."""
    lib = ctypes.CDLL(build()["path"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cp_physics_step.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.cp_physics_step.restype = i32
    lib.cp_render.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                              ptr]
    lib.cp_render.restype = i32
    lib.cp_pack_setups.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.cp_pack_setups.restype = i32
    lib.cp_roofline.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.cp_roofline.restype = i32
    lib.cp_roofline_geometry.argtypes = [i32, i32, ptr]
    lib.cp_roofline_geometry.restype = i32
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")

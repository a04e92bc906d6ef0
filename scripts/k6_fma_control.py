#!/usr/bin/env python3
"""A control for K6's fma chains: the card's rate of fused multiply-adds by
type, and whether more warps or more chains a thread move it.

    python3 scripts/k6_fma_control.py [--out FILE]

K6's fma_bf16 chain (csrc/roofline.cu) reaches about half of the rate the
CUDA C++ Programming Guide gives paired 16-bit multiply-adds at compute
capability 9.0 (256 results a clock an SM).  This script tells apart the
two readings of that: HFMA2 on bfloat16 pairs runs at half the rate of
HFMA2 on float16 pairs, or the chain is short of independent work.  It
builds one CUDA source of its own with nvcc for sm_90a (in a temporary
directory) and runs a chain ``v = v·s + c`` (FFMA on float32, HFMA2 on a
``__half2`` or ``__nv_bfloat162`` pair; ``s`` and ``c`` read from memory,
so nothing folds) over one wave of SMs × B blocks of 128 threads, each
thread carrying K independent chains, unrolled 32 steps a pass, at N and
2N iterations.  For each type and (K, B) it prints one JSON line: the rate
from the difference of the two times (least of 5 CUDA-event times each),
in multiply-add results per second and per clock per SM at the card's
``clocks.max.sm``, the sampled ``clocks.sm``, and the kernel's SASS
opcodes with their modifiers (``cuobjdump -sass``).  The last line holds
every run with the card's ``nvidia-smi`` name and power limit, and is
written to ``--out`` when given.  Needs a CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch import kernels  # noqa: E402

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float fma_of(float v, float s, float c) { return fmaf(v, s, c); }
__device__ __forceinline__ __half2 fma_of(__half2 v, __half2 s, __half2 c) {
  return __hfma2(v, s, c);
}
__device__ __forceinline__ __nv_bfloat162 fma_of(__nv_bfloat162 v, __nv_bfloat162 s,
                                                 __nv_bfloat162 c) {
  return __hfma2(v, s, c);
}

// iters, a multiple of 32, steps of K independent chains a thread.
template <typename T, int K>
__global__ void __launch_bounds__(128) fma_chain(const T* __restrict__ x, T* __restrict__ out,
                                                 const T* __restrict__ sc, int iters) {
  const int n = gridDim.x * blockDim.x, t = blockIdx.x * blockDim.x + threadIdx.x;
  const T s = sc[0], c = sc[1];
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = x[k * n + t];
  for (int i = 0; i < iters; i += 32) {
#pragma unroll
    for (int u = 0; u < 32; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = fma_of(v[k], s, c);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[k * n + t] = v[k];
}

#define CONTROL(T, NAME, K)                                                                 \
  extern "C" int NAME##_k##K(const void* x, void* out, const void* sc, int iters, int grid, \
                             void* stream) {                                                \
    fma_chain<T, K><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(                  \
        static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(sc), iters);  \
    return static_cast<int>(cudaGetLastError());                                            \
  }
CONTROL(float, f32, 4)
CONTROL(float, f32, 8)
CONTROL(__half2, f16, 4)
CONTROL(__half2, f16, 8)
CONTROL(__nv_bfloat162, bf16, 4)
CONTROL(__nv_bfloat162, bf16, 8)
"""

# type → (torch dtype, elements a unit, mangled-name fragment of the unit type)
TYPES = {"f32": (torch.float32, 1, "IfLi"), "f16": (torch.float16, 2, "I7__half2Li"),
         "bf16": (torch.bfloat16, 2, "I14__nv_bfloat162Li")}
# (type, K, blocks an SM): K6's fma_f32 and fma_bf16 geometry (4, 10) and
# (4, 5), then 16 blocks (16 warps a scheduler) with 4 and 8 chains.
RUNS = [("f32", 4, 10), ("f32", 4, 16), ("f16", 4, 5), ("f16", 4, 16), ("f16", 8, 16),
        ("bf16", 4, 5), ("bf16", 4, 16), ("bf16", 8, 16)]
ITERS = 60000 // 32 * 32
THREADS = 128


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def build(tmp: str) -> str:
    src, lib = os.path.join(tmp, "fma_control.cu"), os.path.join(tmp, "libfma_control.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                    "-fPIC", "-shared", "-o", lib, src], check=True, timeout=300)
    return lib


def sass_opcodes(lib: str) -> dict[str, dict[str, int]]:
    """Each kernel's opcodes with their modifiers, by mangled name."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out, name = {}, None
    for line in dump.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            out[name] = collections.Counter()
        elif name and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", line)):
            out[name][m.group(1)] += 1
    return {k: dict(v) for k, v in out.items()}


def best_ms(fn, reps: int = 5) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="file for the last line's JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k6_fma_control needs a CUDA card")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_max = float(smi("clocks.max.sm").split()[0]) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = build(tmp)
        lib = ctypes.CDLL(lib_path)
        opcodes = sass_opcodes(lib_path)
    stream = torch.cuda.current_stream(dev).cuda_stream
    runs = []
    for kind, k, blocks in RUNS:
        dtype, per_unit, mangled = TYPES[kind]
        grid = sms * blocks
        x = torch.full((k * grid * THREADS * per_unit,), 0.25, dtype=dtype, device=dev)
        out = torch.empty_like(x)
        sc = torch.full((2 * per_unit,), 0.5, dtype=dtype, device=dev)
        fn = getattr(lib, f"{kind}_k{k}")

        def launch(iters, fn=fn, x=x, out=out, sc=sc, grid=grid):
            err = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                     ctypes.c_void_p(sc.data_ptr()), iters, grid, ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"{kind} K={k}: CUDA error {err}")

        t1, t2 = best_ms(lambda: launch(ITERS)), best_ms(lambda: launch(2 * ITERS))
        clock_sm = float(smi("clocks.sm").split()[0]) * 1e6
        results = x.numel() * ITERS / ((t2 - t1) / 1e3)
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{kind} K={k}: non-finite output")
        name = next(n for n in opcodes if f"fma_chain{mangled}{k}E" in n)
        run = {"type": kind, "k": k, "blocks_per_sm": blocks, "warps_per_scheduler": blocks,
               "t1_ms": t1, "t2_ms": t2, "fma_results_per_s": results,
               "results_per_clock_per_sm": results / (sms * clock_max),
               "clocks_sm_mhz": clock_sm / 1e6, "sass": opcodes[name]}
        print(json.dumps(run), flush=True)
        runs.append(run)
    line = {"card": smi("name,power.limit"), "sms": sms, "clocks_max_sm_mhz": clock_max / 1e6,
            "iters": ITERS, "runs": runs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line))


if __name__ == "__main__":
    main()

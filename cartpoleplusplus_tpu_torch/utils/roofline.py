"""The card's element-op rate probe (kernel K6, csrc/roofline.cu).

Port of ``measure_vpu`` in scripts/roofline.py: six elementwise op chains,
each timed at N and 2N iterations over a (512, 1280) block, the rate taken
from the difference (which cancels the launch and the block's loads and
stores).  ``CHAINS`` holds each chain's op count per element per iteration,
the JAX probe's own.  :func:`run_chain` launches the kernel for a CUDA
tensor and runs :func:`plain_chain`, the plain PyTorch version, for a CPU
one; :func:`measure_vpu` times the kernel and needs the card.

The kernel runs one wave sized to the card, K chains a thread; :func:`split`
mirrors how it divides the block (:func:`geometry` reads the launch it makes
on the card), and :func:`interleaved_chain` runs the plain chains in that
division.  :func:`issue_bound` prices a chain's loop body, its SASS opcodes
per element-iteration, at the card's instruction throughputs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cartpoleplusplus_tpu_torch import kernels

SHAPE = (512, 1280)
ITERS = 60000
# name → (enum Chain in csrc/roofline.cu, ops per element per iteration, dtype)
CHAINS = {
    "fma_f32": (0, 2, torch.float32),
    "fma_bf16": (1, 2, torch.bfloat16),
    "mix_f32": (2, 5, torch.float32),
    "mix_bf16": (3, 5, torch.bfloat16),
    "recip_f32": (4, 3, torch.float32),
    "div_f32": (5, 3, torch.float32),
}


# The kernel's launch (csrc/roofline.cu): threads per block (one warp per
# scheduler) and independent chains per thread, by chain (div_f32's
# divisions run one after another in a thread, so it takes 3 chains and
# more warps).
THREADS = 128
CHAINS_PER_THREAD = {mix: 3 if mix == "div_f32" else 4 for mix in CHAINS}
WARP = 32
SCHEDULERS_PER_SM = 4

# Throughput of native arithmetic instructions at compute capability 9.0,
# in results per clock per SM (CUDA C++ Programming Guide, "Arithmetic
# Instructions", table "Throughput of Native Arithmetic Instructions"):
# class → (results per clock per SM, results per instruction, SASS opcodes).
# A paired 16-bit instruction (HFMA2 on a bfloat16 pair) gives two results.
THROUGHPUT_CC90 = {
    "fp32 add/mul/fma": (128, 1, ("FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I")),
    "fp16/bf16 add/mul/fma": (256, 2, ("HFMA2", "HADD2", "HMUL2", "HFMA2_32I", "HADD2_32I",
                                       "HMUL2_32I")),
    "mufu rcp/rsqrt/lg2/ex2/sin/cos": (16, 1, ("MUFU",)),
    "compare/min/max": (64, 1, ("FSETP", "FSET", "FMNMX", "ISETP", "IMNMX")),
    "int32 add": (64, 1, ("IADD3", "IADD", "VIADD", "IADD32I")),
    "int32 bitwise and/or/xor": (64, 1, ("LOP3", "LOP", "LOP32I")),
}
_CLASS_OF = {op: name for name, (_, _, ops) in THROUGHPUT_CC90.items() for op in ops}


def issue_bound(opcodes_per_elem_iter: dict, sm_count: int, clock_hz: float) -> dict:
    """The least time a loop body can take on the card, from its SASS
    opcodes per element-iteration (``{"FFMA": 1.0, ...}``; a paired
    bfloat16 instruction counts 0.5 per element) → ``{"el_iter_per_s",
    "bound_by", "clocks_per_el_iter", "unpriced"}``.

    An SM issues one warp instruction per clock on each of its schedulers
    (the ``issue`` bound), and each class of :data:`THROUGHPUT_CC90` runs at
    its own rate; the bound is the largest of these clocks per
    element-iteration per SM (a tie goes to ``issue``).  An opcode of no
    class there is priced at the FFMA rate, which is optimistic, and listed
    in ``unpriced``."""
    clocks = {"issue": sum(opcodes_per_elem_iter.values()) / (SCHEDULERS_PER_SM * WARP)}
    for name, (rate, per_instr, ops) in THROUGHPUT_CC90.items():
        count = sum(opcodes_per_elem_iter.get(op, 0) for op in ops)
        if count:
            clocks[name] = count * per_instr / rate
    unpriced = sorted(op for op in opcodes_per_elem_iter if op not in _CLASS_OF)
    ffma_rate = THROUGHPUT_CC90["fp32 add/mul/fma"][0]
    for op in unpriced:
        clocks[f"{op} (unpriced: FFMA rate)"] = opcodes_per_elem_iter[op] / ffma_rate
    by = max(clocks, key=clocks.get)
    return {"el_iter_per_s": sm_count * clock_hz / clocks[by], "bound_by": by,
            "clocks_per_el_iter": clocks, "unpriced": unpriced}


def units_of(mix: str, n: int) -> int:
    """The kernel's units of an n-element block: elements, or bfloat16 pairs."""
    return n // 2 if CHAINS[mix][2] == torch.bfloat16 else n


def split(units: int, sm_count: int, max_blocks: int, k: int, threads: int = THREADS) -> dict:
    """How K6 divides ``units`` over the card (csrc/roofline.cu
    ``geometry``): ``blocks_per_sm`` blocks of ``threads`` on each of
    ``sm_count`` SMs (enough warps for ``k`` units a thread, at most
    ``max_blocks``, the most an SM holds), one wave of ``grid`` blocks;
    every thread's first ``full`` slots are whole rounds of the block, and
    slot ``full`` takes the ``rest``, in runs of equal length per block."""
    per_sm = sm_count * WARP * k
    warps = -(-units // per_sm)
    blocks = min(max(-(-warps // (threads // WARP)), 1), max_blocks)
    grid = sm_count * blocks
    full, rest = divmod(units, grid * threads)
    return {"sms": sm_count, "blocks_per_sm": blocks, "grid": grid, "threads": threads, "k": k,
            "full": full, "rest": rest, "slots": full + (rest > 0)}


def slot_units(geo: dict) -> torch.Tensor:
    """The unit each slot of each thread holds, as the kernel takes them:
    (slots rounded up to k, threads) int64, -1 where a slot holds none."""
    grid, threads, full, rest = geo["grid"], geo["threads"], geo["full"], geo["rest"]
    n_threads = grid * threads
    t = torch.arange(n_threads, dtype=torch.int64)
    b, i = t // threads, t % threads
    lo, hi = b * rest // grid, (b + 1) * rest // grid
    last = torch.where(i < hi - lo, full * n_threads + lo + i, -1)
    rows = math.ceil(geo["slots"] / geo["k"]) * geo["k"]
    return torch.stack([s * n_threads + t if s < full else last if s == full
                        else torch.full_like(t, -1) for s in range(rows)])


def interleaved_chain(mix: str, x: torch.Tensor, iters: int, sm_count: int,
                      max_blocks: int) -> torch.Tensor:
    """The fused plain chains run as K6 divides them: each thread's slots
    side by side, dummy slots starting from 1.0, the units written back
    where they came from."""
    pairs = CHAINS[mix][2] == torch.bfloat16
    flat = x.reshape(-1, 2 if pairs else 1)
    idx = slot_units(split(flat.shape[0], sm_count, max_blocks, CHAINS_PER_THREAD[mix]))
    live = idx >= 0
    v = torch.where(live[..., None], flat[idx.clamp(min=0)], torch.ones((), dtype=x.dtype))
    for _ in range(iters):
        v = _step(mix, v, fused=True)
    out = torch.empty_like(flat)
    out[idx[live]] = v[live]
    return out.reshape(x.shape)


def _fma(v: torch.Tensor, scale, shift) -> torch.Tensor:
    """``v·scale + shift`` rounded once to ``v``'s dtype, as an FFMA or
    HFMA2 rounds it: float64 holds the product and, for these constants
    and ``v`` in [2^-7, 4), the sum exactly."""
    return (v.double() * float(scale) + float(shift)).to(v.dtype)


def _step(mix: str, v: torch.Tensor, fused: bool) -> torch.Tensor:
    """One iteration of a chain's body (scripts/roofline.py:112-149); the
    reciprocal is exact here and approximate in the kernel."""
    if mix not in CHAINS:
        raise ValueError(f"unknown chain {mix!r}; one of {sorted(CHAINS)}")
    if mix.endswith("bf16"):  # constants rounded to bfloat16, as jnp.bfloat16(...) rounds them
        const = lambda c: torch.tensor(c, dtype=torch.bfloat16, device=v.device)
        scale, shift, floor = const(1.001), const(1e-3), const(0.5)
    else:
        scale, shift, floor = torch.tensor(1.0000001).item(), torch.tensor(1e-7).item(), 0.5
    if mix.startswith("fma"):
        return _fma(v, scale, shift) if fused else v * scale + shift
    if mix.startswith("mix"):
        a, b = v * scale, v + shift
        return torch.clamp(torch.where(b > a, a, b), min=floor)
    if mix == "recip_f32":
        r = torch.reciprocal(v)
        return _fma(r, scale, 1.0) if fused else r * scale + 1.0
    # div_f32: a true division (``scalar / tensor`` multiplies by a reciprocal)
    return torch.full_like(v, scale) / v + 1.0


def initial(mix: str, shape=SHAPE, device="cpu") -> torch.Tensor:
    """The block a chain starts from when timed: every element 1.001."""
    return torch.full(shape, 1.001, dtype=CHAINS[mix][2], device=device)


def varied(mix: str, shape=SHAPE, device="cpu") -> torch.Tensor:
    """A block of distinct starting values on which every chain moves each
    iteration: float32 in [0.5, 2) (``mix_f32``'s add of 1e-7 is lost from
    2 up), bfloat16 in [2^-6, 0.45] (the bfloat16 scale 1.001 rounds to 1,
    and the shift 1e-3 is more than half an ulp only below 0.5)."""
    n = 1
    for d in shape:
        n *= d
    lo, hi = (0.5, 2.0 - 2.0**-20) if CHAINS[mix][2] == torch.float32 else (2.0**-6, 0.45)
    return torch.linspace(lo, hi, n, device=device).reshape(shape).to(CHAINS[mix][2])


def plain_chain(mix: str, x: torch.Tensor, iters: int, fused: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``iters`` iterations of the chain's body.
    With ``fused`` the multiply-adds of ``fma_*`` and ``recip_f32`` are
    rounded once, as the kernel's FFMA and HFMA2 round them; without, each
    op is rounded as the JAX body rounds it."""
    v = x
    for _ in range(iters):
        v = _step(mix, v, fused)
    return v


def launch(mix: str, x: torch.Tensor, out: torch.Tensor, iters: int) -> None:
    """Launch K6 on prepared contiguous CUDA buffers of the chain's dtype.
    Counts nothing: :func:`run_chain` counts."""
    err = kernels.library().cp_roofline(
        x.data_ptr(), out.data_ptr(), x.numel(), iters, CHAINS[mix][0],
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "roofline")


def run_chain(mix: str, x: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` iterations of chain ``mix`` over ``x`` → a new tensor: K6
    for a CUDA tensor (or raise), the plain version for a CPU one."""
    if x.dtype != CHAINS[mix][2]:
        raise ValueError(f"{mix}: expected {CHAINS[mix][2]}, got {x.dtype}")
    if x.device.type == "cpu":
        return plain_chain(mix, x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    launch(mix, x, out, iters)
    kernels.LAUNCHES["roofline_" + mix] += 1
    return out


def geometry(mix: str, n: int) -> dict:
    """The launch K6 makes on the current card for chain ``mix`` over n
    elements: :func:`split`'s keys, ``max_blocks`` (what an SM holds by the
    kernel's registers and threads), ``smem`` (the dynamic shared memory a
    block asks for, so that an SM holds no more than ``blocks_per_sm``) and
    ``unroll`` (steps per pass of the unrolled loop)."""
    vals = (ctypes.c_int * 11)()
    kernels.check(kernels.library().cp_roofline_geometry(CHAINS[mix][0], n, vals), "roofline")
    keys = ("sms", "max_blocks", "blocks_per_sm", "grid", "threads", "smem", "k", "unroll",
            "full", "rest", "slots")
    return dict(zip(keys, vals))


def _best_ms(fn, reps: int) -> float:
    """Least CUDA-event time of one call over ``reps`` calls, in ms."""
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


def measure_chain(mix: str, iters: int = ITERS, shape=SHAPE, device="cuda",
                  reps: int = 5) -> dict:
    """Time chain ``mix`` on the card at ``iters`` and ``2·iters``
    iterations → ``{"ops_per_el_per_iter", "el_ops_per_s", "t1_ms",
    "t2_ms", "attempts"}``.  As the JAX probe does, a pair whose difference
    is under a fifth of the first time is taken again, up to four times."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("measure_chain times the kernel and needs a CUDA device")
    ops = CHAINS[mix][1]
    x = initial(mix, shape, dev)
    for attempt in range(1, 5):
        t1 = _best_ms(lambda: run_chain(mix, x, iters), reps)
        t2 = _best_ms(lambda: run_chain(mix, x, 2 * iters), reps)
        if t2 - t1 > 0.2 * t1:
            break
    else:
        raise RuntimeError(f"{mix}: timing never stabilized (t1={t1:.4f} ms t2={t2:.4f} ms)")
    rate = ops * iters * x.numel() / ((t2 - t1) / 1e3)
    return {"ops_per_el_per_iter": ops, "el_ops_per_s": rate, "t1_ms": t1, "t2_ms": t2,
            "attempts": attempt}


def measure_vpu(iters: int = ITERS, shape=SHAPE, device="cuda") -> dict:
    """Every chain's rate on the card → ``{mix: (ops_per_el_per_iter,
    el_ops_per_s)}``, as scripts/roofline.py's ``measure_vpu`` returns."""
    out = {}
    for mix in CHAINS:
        m = measure_chain(mix, iters, shape, device)
        out[mix] = (m["ops_per_el_per_iter"], m["el_ops_per_s"])
    return out

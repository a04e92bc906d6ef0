#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cartpoleplusplus_tpu_torch/csrc`` with plain
nvcc, holds each kernel against its plain PyTorch version on the card, then
drives the port's paths at full width (4096 envs, 50×50 renders, obs_pool 2,
3 repeats × 5 substeps, 3 solver iterations), each with the launch counts
set to 0 just before it and read just after:

- acting at config 5 (2 cameras, obs_samples 2, slab render): a greedy DDPG
  actor with seeded random weights runs full evaluation rollouts, then
  windows of lazily auto-resetting steps, each over a second;
- DDPG training as the bench trains (``utils/benchmark.py``: its
  ``build`` with its hyperparameters, replay 8192, batch 128, 20 steps per
  segment, Adam 1e-4/1e-3, γ 0.99, τ 0.005, warmup 0, OU θ 0.15 σ 0.2;
  one warm segment, then its timed windows and their best rate) at
  config 5 and at the 1-camera exact row (obs_samples 0, raster render,
  K5a), and at three rows of the render kernel's other modes, each a
  bench flag: config 5 with ``--no-render-recip`` (K5b), the 1-camera
  exact row with ``--raster-hoist`` (K5c) and with ``--render-mxu`` (K5d);
- one TD3 segment at the 1-camera exact row;
- the low-dim path at 8192 envs (the bench's fourth row, no renderer): K1's
  frames and states byte-equal to the JAX venv's per-repeat composition run
  through the port's kernels (K2 per repeat, then ``observe_lowdim``) on
  the main path's reset states and on seeded states, then a training row
  as above;
- the card's element-op rate probe (K6): six op chains timed at N and 2N
  iterations;
- the port's bench (``bench_torch.py``, its four-row suite, each row in a
  child process of its own): four row lines and the summary, every row on
  the card with its mix rate measured there, the low-dim row's metric
  without ``_pixel_render``.

Each kernel is held against its plain version on seeded states and on the
paths' own inputs and timed there (``parity_modes`` for K5b-K5d, with K5c
byte-equal to K5a and K5d within the silhouette rule of K5a;
``parity_owed`` for K3/K4 at one sample per pooled pixel, on poses chosen
to break the slab kernel's cull (``raycast.cull_probe_poses``) and at two
frame sizes too large to stage three repeats of in shared memory, and
K1/K2 at 8192 envs and at 4097, a count that is not a multiple of 32;
``parity_training_end`` for K3 on poses from the end of the config-5
training row, where it is also timed); torch.profiler traces of a few
acting steps and of one training segment per row give the card's busy
share and the learner's share of it.  On every slab pose set the cull of
K3/K4 and of K5b is checked where it could fail (``cull_check``: no
skipped cast that the plain cast of the mode hits, frames byte-equal to
the kernel's own with culling off, and K5b's byte-equal to the plain ratio
version's) and the share of box casts it skips is printed; likewise K5a's,
K5c's and K5d's cull on every raster pose set (``raster_cull_check`` in
``parity_raster_cull`` and ``parity_training_end``: the 1cam_exact row's
main-path and training-end poses, seeded states and the probe's poses
seen by 2 cameras, the probe's seen by 1, and a frame too large to stage
in shared memory), where K5a and K5c must also equal the plain raster byte
for byte and K5d keep the silhouette rule against K5a and its plain
version.  K5c's setup pass is held byte-equal to ``raycast.pack_setups``.
Each phase prints one JSON line with the elapsed seconds and its own
(``phase_s``); the line before
the last two holds every kernel's launches, error, time, bound, registers
and spills (every render kernel culls: its bound counts the work these
inputs need, with the full-work bound beside it); the last line is
``{"ok": true, "device": {...}}``.

A watchdog turns a hang into a traceback and a nonzero exit after 300 s.
Without CUDA, or without the port beside it, the script fails before
printing any result.
"""

from __future__ import annotations

import argparse
import collections
import faulthandler
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.agents import ddpg
from cartpoleplusplus_tpu_torch.agents.common import eval_rollout, make_venv
from cartpoleplusplus_tpu_torch.agents.ddpg import greedy_act
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.env.vector import resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import Actor
from cartpoleplusplus_tpu_torch.physics import cuda_step, soa
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.render import raycast
from cartpoleplusplus_tpu_torch.render.cuda_render import (
    RASTER_FRAME_BYTES, Renderer, slab_blocking)
from cartpoleplusplus_tpu_torch.replay import buffer as replay_mod
from cartpoleplusplus_tpu_torch.utils import benchmark, roofline
from cartpoleplusplus_tpu_torch.utils.benchmark import device_events

WATCHDOG_S = 300
SEED = 0
NUM_ENVS = 4096
PARITY_ENVS = 1024
OWED_PHYS_ENVS = 8192  # K1/K2 parity at twice the main path's width
RAGGED_ENVS = 4097     # K1/K2 parity at a count that is not a multiple of 32
PROBE_POSES = 4096     # raycast.cull_probe_poses: poses chosen to break K3's cull
SIM_ONLY_WINDOWS = 3
EVAL_ROLLOUTS = 3
SIM_ONLY_STEPS = 700  # per window: over a second at 1.6-1.9 ms per step
PROFILE_STEPS = 20
# Published H100 SXM peaks: HBM bandwidth and float32 (non-tensor-core)
# rate; the non-tensor-core bfloat16 rate is twice the float32 one
# (NVIDIA's Hopper architecture whitepaper: 133.8 TFLOP/s).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 133.8e12
# Tolerances: physics atol, pixel levels (|Δ| ≤ 2 on ≥ 99.9%, mean < 0.5).
PHYS_ATOL = 1e-5
PIX_LEVEL, PIX_SHARE, PIX_MEAN = 2, 0.999, 0.5
# K5d against K5a and its plain version (tests/test_raster_render.py's rule
# for the product's rounding): under 1e-3 of bytes differ, and every
# differing pixel lies within one pixel of a silhouette edge of more than 4
# levels.
SIL_SHARE, SIL_EDGE = 1e-3, 4
# K6 against its fused plain chains (each multiply-add rounded once, as
# FFMA/HFMA2 do) after K6_PARITY_ITERS iterations from roofline.varied's
# distinct starts: float32 within 1e-6 (a few ulp; recip_f32's reciprocal
# is approximate in the kernel), bfloat16 within one ulp below 0.5 (2^-9),
# and either within K6_MOVE_SHARE of how far the plain chain moved.  The
# chains move 3e-5 (mix_f32) to 1.1 (recip_f32, div_f32) there.
K6_PARITY_ITERS = 256
K6_ATOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-9}
K6_MOVE_SHARE = 0.01
K6_ROW_ITERS = 1000  # the chains' iterations in the kernels line

_ROW = dict(discrete_actions=False, use_raw_pixels=True, render_width=50, render_height=50,
            obs_pool=2, action_repeats=3, steps_per_repeat=5, solver_iterations=3)
CONFIG5 = CartpoleConfig(num_cameras=2, obs_samples=2, **_ROW)        # 2cam_samples2
CONFIG1_EXACT = CartpoleConfig(num_cameras=1, obs_samples=0, **_ROW)  # 1cam_exact
CONFIG2_EXACT = CartpoleConfig(num_cameras=2, obs_samples=0, **_ROW)  # raster parity only
CONFIG1_S1 = CartpoleConfig(num_cameras=1, obs_samples=1, **_ROW)     # 1cam_samples1: p2 = 1
# Frames larger than the slab kernel stages in shared memory for 3 repeats:
# config 5 at 192 x 192 (a frame over SLAB_FRAME_BYTES: written straight to
# global memory) and one camera unpooled at 124 x 124 (one repeat per block).
CONFIG5_WIDE = CartpoleConfig(num_cameras=2, obs_samples=2,
                              **{**_ROW, "render_width": 192, "render_height": 192})
CONFIG1_UNPOOLED = CartpoleConfig(num_cameras=1, obs_samples=1, **{
    **_ROW, "render_width": 124, "render_height": 124, "obs_pool": 1})
# A raster frame over RASTER_FRAME_BYTES: 2 cameras exact at 192 x 192
# (written straight to global memory).
CONFIG2_EXACT_WIDE = CartpoleConfig(num_cameras=2, obs_samples=0,
                                    **{**_ROW, "render_width": 192, "render_height": 192})
LARGE_FRAME_ENVS = 256
# The bench's low-dim row: 8192 envs, no renderer.
LOWDIM_ENVS = 8192
# The bench phase runs bench_torch.py's suite as a child process: each row in
# a child of its own, watchdogged at BENCH_ROW_TIMEOUT_S; the whole suite is
# killed BENCH_MARGIN_S before this script's own watchdog would fire.
BENCH_ROW_TIMEOUT_S = 60
BENCH_MARGIN_S = 10

# The bench's training hyperparameters (utils/benchmark.py build) and the
# TD3 recipe's stabilizers.
REPLAY_CAPACITY = 8192
TRAIN_HP = dict(gamma=0.99, tau=0.005, batch_size=128, warmup_steps=0, steps_per_segment=20,
                ou_theta=0.15, ou_sigma=0.2)
TD3_HP = dict(twin_critic=True, policy_delay=2, target_noise=0.2, aug_shift=2,
              reward_scale=0.1, grad_clip=10.0)
# The polyak step target ← target + τ·(online − target), checked in norm.
TARGET_STEP_RTOL = 1e-3
_PHYS = ("step_repeats", "step_substeps")
# (row, the bench's options for it at NUM_ENVS, kernels the row must launch)
TRAIN_ROWS = (
    ("2cam_samples2", dict(num_cameras=2, obs_samples=2),
     (*_PHYS, "render_repeats", "render_batched")),
    ("1cam_exact", dict(num_cameras=1, obs_samples=0),
     (*_PHYS, "render_repeats_raster", "render_batched_raster")),
    ("2cam_samples2_ratio", dict(num_cameras=2, obs_samples=2, render_recip=False),
     (*_PHYS, "render_repeats_ratio", "render_batched_ratio")),
    ("1cam_exact_hoist", dict(num_cameras=1, obs_samples=0, raster_hoist=True),
     (*_PHYS, "pack_setups", "render_repeats_raster_hoist", "render_batched_raster_hoist")),
    ("1cam_exact_mxu", dict(num_cameras=1, obs_samples=0, render_mxu=True),
     (*_PHYS, "render_repeats_raster_mxu", "render_batched_raster_mxu")),
)
# The render modes of parity_modes: (name, Renderer options, config at the
# main path's inputs); the seeded inputs are seen by 2 cameras.
MODES = (
    ("ratio", dict(recip=False), CONFIG5),
    ("raster_hoist", dict(raster=True, hoist=True), CONFIG1_EXACT),
    ("raster_mxu", dict(raster=True, mxu=True), CONFIG1_EXACT),
    ("raster_hoist_mxu", dict(raster=True, hoist=True, mxu=True), CONFIG1_EXACT),
)

KERNELS = (
    ("step_repeats", "cartpoleplusplus_tpu_torch/csrc/physics.cu",
     "cartpoleplusplus_tpu/physics/pallas_step.py:113"),
    ("step_substeps", "cartpoleplusplus_tpu_torch/csrc/physics.cu",
     "cartpoleplusplus_tpu/physics/pallas_step.py:180"),
    ("render_repeats", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:347"),
    ("render_batched", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:436"),
    ("render_repeats_raster", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:225"),
    ("render_batched_raster", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:225"),
    ("render_repeats_ratio", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:210"),
    ("render_batched_ratio", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:210"),
    ("pack_setups", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:111"),
    ("render_repeats_raster_hoist", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:226"),
    ("render_batched_raster_hoist", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:226"),
    ("render_repeats_raster_mxu", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:248"),
    ("render_batched_raster_mxu", "cartpoleplusplus_tpu_torch/csrc/render.cu",
     "cartpoleplusplus_tpu/render/pallas_kernel.py:248"),
    *((f"roofline_{mix}", "cartpoleplusplus_tpu_torch/csrc/roofline.cu", "scripts/roofline.py:56")
      for mix in roofline.CHAINS),
)


class OpCensus(TorchDispatchMode):
    """Counts element operations of the arithmetic ATen ops a function runs:
    each op adds its output's element count (a reduction its input's).
    Views, copies, dtype casts, concatenation and allocation are not
    counted."""

    ELEMENTWISE = {
        "add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "rsqrt", "sqrt",
        "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where", "abs",
        "floor", "ge", "gt", "le", "lt", "eq", "ne", "bitwise_and", "bitwise_or",
        "bitwise_not", "logical_and", "logical_or", "logical_not", "sin", "cos",
        "atan2", "asin", "tanh", "relu",
    }
    REDUCTIONS = {"sum", "mean"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in self.REDUCTIONS:
            self.ops += args[0].numel()
        elif name in self.ELEMENTWISE and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def census(fn) -> int:
    with OpCensus() as c:
        fn()
    return c.ops


def sass_opcodes(lib_path: str, function: str) -> dict | None:
    """Opcode counts of one kernel's SASS in the built library, by
    ``cuobjdump -sass`` (None where the toolkit has no cuobjdump)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    dump = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in dump.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] += 1
    return dict(counts)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int = 20) -> float | None:
    """Mean device time per call of ``fn`` from a torch.profiler trace of
    ``reps`` calls: the kernels' own durations, without the host's time
    between launches (which bounds :func:`time_ms` where a kernel is
    shorter than a wrapper's call).  None where the trace holds no device
    time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in device_events(prof))
    return us / 1e3 / reps if us else None


def state_err(a: RigidState, b: RigidState) -> float:
    return max(float((getattr(a, f) - getattr(b, f)).abs().max()) for f in ("pos", "quat", "vel", "ang"))


def pixel_check(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    if got.shape != want.shape or got.dtype != torch.uint8:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs {tuple(want.shape)}")
    d = (got.int() - want.int()).abs()
    beyond = float((d > PIX_LEVEL).float().mean())
    res = {"max_abs_err": int(d.max()), "share_beyond_2": beyond,
           "mean_abs_err": float(d.float().mean())}
    if 1.0 - beyond < PIX_SHARE or res["mean_abs_err"] >= PIX_MEAN:
        raise AssertionError(f"{name} disagrees with its plain version: {res}")
    return res


def cast_mask(scene, rnd, poses) -> torch.Tensor:
    """The plain predicate of the casts ``rnd``'s kernel makes on poses
    (E, 16) (``raycast.slab_cast_mask``, or ``raster_cast_mask`` for K5a
    and K5d)."""
    args = (scene, poses, rnd.planes, rnd.cam_meta, rnd.p2, rnd.n)
    if rnd.raster:
        return raycast.raster_cast_mask(*args, rnd.order, mxu=rnd.mxu)
    return raycast.slab_cast_mask(*args, rnd.width)


def cast_shares(scene, rnd, poses) -> dict:
    """Share of box casts a column-run kernel's cull skips on poses (R, E,
    16), for the cart and the pole: of all (sub-ray, box) casts, those in
    warps that skip the box (the plain predicate, :func:`cast_mask`)."""
    skipped = torch.stack([
        1.0 - cast_mask(scene, rnd, poses[r]).float().mean(dim=(0, 1, 2))
        for r in range(poses.shape[0])]).mean(0)
    return {"cart": float(skipped[0]), "pole": float(skipped[1])}


def cull_check(scene, rnd, poses, name: str) -> dict:
    """The slab kernel's cull on poses (R, E, 16) in ``rnd``'s cast mode
    (K3/K4, or K5b where ``rnd.recip`` is False), where it could fail: the
    casts the plain predicate skips that the mode's slab cast hits
    (``raycast.slab_cull_violations``, which must be 0), and the kernel's
    frames byte-equal to its own with culling off (``ray_abs`` = inf
    widens every cull rectangle to the plane); K5b's frames byte-equal to
    the plain ratio version's too.  Plus the share of casts skipped."""
    violations = sum(raycast.slab_cull_violations(scene, poses[r], rnd.planes, rnd.cam_meta,
                                                  rnd.p2, rnd.n, rnd.width, rnd.recip)
                     for r in range(poses.shape[0]))
    frames = []
    for ray_abs in (rnd.ray_abs, float("inf")):
        params = rnd.kernel_params(scene)
        params.ray_abs = ray_abs
        out = torch.empty((poses.shape[1], poses.shape[0], rnd.frame_width), dtype=torch.uint8,
                          device=poses.device)
        rnd.launch(params, poses.contiguous(), out)
        frames.append(out)
    differ = int((frames[0] != frames[1]).sum())
    if violations or differ:
        raise AssertionError(f"{name}: the slab cull skipped {violations} hitting casts; "
                             f"{differ} bytes differ from the kernel's frames without culling")
    res = {"violations": violations, "bytes_differing_from_uncull": differ,
           "skipped_cast_share": cast_shares(scene, rnd, poses)}
    if not rnd.recip:
        if not torch.equal(frames[0], rnd.plain(scene, poses)):
            raise AssertionError(f"{name}: K5b's frames differ from the plain ratio version's")
        res["levels_vs_plain"] = 0
    return res


def slab_cull_checks(scene, cfg, poses, name: str) -> dict:
    """:func:`cull_check` of K3/K4 and of K5b on poses (R, E, 16) seen by
    ``cfg``'s cameras."""
    return {key: cull_check(scene, Renderer(cfg, poses.device, recip=recip), poses,
                            f"{name} {key}")
            for key, recip in (("k3", True), ("k5b", False))}


def raster_cull_check(scene, cfg, poses, name: str) -> dict:
    """K5a's, K5c's and K5d's cull on poses (R, E, 16) seen by ``cfg``'s
    cameras, where it could fail: no skipped cast that the plain cast hits
    (``raycast.raster_cull_violations``, which must be 0), and each
    kernel's frames byte-equal to its own with the cull off
    (``RenderParams.cull`` = 0).  K5a's and K5c's frames must equal the
    plain raster's; K5d's keep the silhouette rule against K5a's and against
    its plain version.  Plus the share of casts skipped.  K5c's setups are
    K5a's bit for bit, so its plain predicate, and the count of its
    violations, are K5a's."""
    dev, r = poses.device, poses.shape[0]
    k5a = Renderer(cfg, dev, raster=True)
    k5c = Renderer(cfg, dev, raster=True, hoist=True)
    k5d = Renderer(cfg, dev, raster=True, mxu=True)
    out, frames = {}, {}
    for key, rnd in (("k5a", k5a), ("k5c", k5c), ("k5d", k5d)):
        setups = None
        if rnd.hoist:
            setups = torch.empty((*poses.shape[:2], rnd.setup_width), device=dev)
            rnd.launch_pack(rnd.kernel_params(scene), poses.contiguous(), setups)
        by_cull = []
        for cull in (1, 0):
            params = rnd.kernel_params(scene)
            params.cull = cull
            by_cull.append(torch.empty((poses.shape[1], r, rnd.frame_width), dtype=torch.uint8,
                                       device=dev))
            rnd.launch(params, poses.contiguous(), by_cull[-1], setups)
        if rnd.hoist:
            violations, shares = out["k5a"]["violations"], out["k5a"]["skipped_cast_share"]
        else:
            violations = sum(raycast.raster_cull_violations(
                scene, poses[i], rnd.planes, rnd.cam_meta, rnd.p2, rnd.n, rnd.order, rnd.mxu)
                for i in range(r))
            shares = cast_shares(scene, rnd, poses)
        differ = int((by_cull[0] != by_cull[1]).sum())
        if violations or differ:
            raise AssertionError(f"{name} {key}: the cull skipped {violations} hitting casts; "
                                 f"{differ} bytes differ from the frames without culling")
        frames[key] = by_cull[0]
        out[key] = {"violations": violations, "bytes_differing_from_uncull": differ,
                    "skipped_cast_share": shares}
    if not torch.equal(frames["k5a"], k5a.plain(scene, poses)):
        raise AssertionError(f"{name}: K5a's frames differ from the plain raster's")
    if not torch.equal(frames["k5c"], frames["k5a"]):
        raise AssertionError(f"{name}: K5c's frames differ from K5a's")
    h, w = cfg.obs_height, cfg.obs_width
    out["k5a"]["levels_vs_plain"] = 0
    out["k5c"]["levels_vs_plain"] = out["k5c"]["levels_vs_k5a"] = 0
    out["k5d"]["silhouette_vs_k5a"] = silhouette_check(f"{name} k5d vs k5a", frames["k5d"],
                                                       frames["k5a"], h, w)
    out["k5d"]["silhouette_vs_plain"] = silhouette_check(f"{name} k5d", frames["k5d"],
                                                         k5d.plain(scene, poses), h, w)
    return out


def needed_plain(scene, rnd, poses):
    """The plain version of the slab mode (reciprocal or, where
    ``rnd.recip`` is False, ratio), or of the raster (``rnd.raster``; K5c's
    and K5d's work is K5a's), doing only the work these inputs need, as a
    function of poses (R, E, 16): each box cast only for the sub-rays it
    hits, a pooled pixel shaded and pooled only where a sub-ray of it hits
    a box, every other pixel the background colour of its static ray rows
    (a table, no operation).  The hits and indices are found here, outside
    the function, by the plain cast.  Its op census is the work these
    inputs need; its frames are the plain version's."""
    p2, n = rnd.p2, rnd.n
    e = poses.shape[1]
    # cast_where → (depth terms, lambert, hit); nearer compares two boxes'
    # depth terms, the cart's first.
    if rnd.raster:
        setup = lambda basis, eye, center, quat, he: raycast._obb_q_setup(
            basis, eye, center, quat, he, raycast.LIGHT_DIR)
        hits_of = lambda rows, su, he: raycast._obb_q_cast(rows[0], rows[1], su)[2]
        cast_where = lambda rows, su, he, m: (lambda q, lam, hit: ((q,), lam, hit))(
            *raycast._obb_q_cast_where(rows[0], rows[1], su, m))
        nearer = lambda c, p: c[0] >= p[0]  # inverse depth
    else:
        recip = rnd.recip
        setup = lambda basis, eye, center, quat, he: raycast._slab_setup(
            basis, eye, center, quat, raycast.LIGHT_DIR)
        hits_of = lambda rows, su, he: raycast._slab_cast(rows[0], rows[1], su, he, recip)[3]
        cast_where = lambda rows, su, he, m: (lambda num, den, lam, hit: ((num, den), lam, hit))(
            *raycast._slab_cast_where(rows[0], rows[1], su, he, m, recip))
        if recip:
            nearer = lambda c, p: c[0] <= p[0]  # depth
        else:
            nearer = lambda c, p: c[0] * p[1] <= p[0] * c[1]  # nc·dp ≤ np·dc
    miss = torch.zeros((1, p2 * n), dtype=torch.bool, device=poses.device)
    zeros = torch.zeros((1, p2 * n), device=poses.device)
    plan, background = [], []
    for c in range(len(rnd.cam_meta)):
        rows = rnd.planes[:, c].reshape(4, 1, p2 * n)
        background.append(raycast.shade_pool(miss, miss, zeros, zeros, rows[2], rows[3], p2, n))
    for r in range(poses.shape[0]):
        for c, (basis, eye) in enumerate(rnd.cam_meta):
            rows = rnd.planes[:, c].reshape(4, 1, p2 * n)
            hits = [hits_of(rows, setup(basis, eye, center, quat, he), he)
                    for center, quat, he in raycast.pose_boxes(scene, poses[r])]
            ie, ij = (hits[0] | hits[1]).reshape(e, p2, n).any(1).nonzero(as_tuple=True)
            sub = (torch.arange(p2, device=poses.device)[:, None] * n + ij).reshape(-1)
            plan.append((hits, ie, ij, ie.repeat(p2), sub))

    def run():
        frames, i = [], 0
        for r in range(poses.shape[0]):
            boxes, out = raycast.pose_boxes(scene, poses[r]), []
            for c, (basis, eye) in enumerate(rnd.cam_meta):
                hits, ie, ij, ie_sub, sub = plan[i]
                i += 1
                rows = rnd.planes[:, c].reshape(4, 1, p2 * n)
                (tc, lc, hc), (tp, lp, hp) = (
                    cast_where(rows, setup(basis, eye, center, quat, he), he, hit)
                    for (center, quat, he), hit in zip(boxes, hits))
                at = lambda t: t[ie_sub, sub][None]  # the hit pixels' sub-rays, p2 blocks
                depth_c, depth_p = tuple(map(at, tc)), tuple(map(at, tp))
                colors = raycast.shade_pool(at(hc) & nearer(depth_c, depth_p), at(hp), at(lc),
                                            at(lp), rows[2][:, sub], rows[3][:, sub], p2, len(ie))
                for k in range(3):
                    plane = background[c][k].expand(e, n).clone()
                    plane[ie, ij] = colors[k][0]
                    out.append(plane)
            frames.append(torch.cat(out, dim=-1))
        return torch.stack(frames, dim=1)

    return run


def probe_rigid(poses: torch.Tensor) -> RigidState:
    """Poses (E, 16) as a RigidState at rest (K4's input)."""
    zeros = torch.zeros((poses.shape[0], 2, 3), device=poses.device)
    return RigidState(pos=torch.stack([poses[:, 0:3], poses[:, 7:10]], 1),
                      quat=torch.stack([poses[:, 3:7], poses[:, 10:14]], 1), vel=zeros, ang=zeros)


# Mangled-name fragments of each kernel's CUDA function, for its ptxas
# registers and spills.
PTXAS_NAMES = {
    "step_repeats": "phys_kernelILb1E", "step_substeps": "phys_kernelILb0E",
    "render_repeats": "render_slab_kernelILi0ELb1E",
    "render_batched": "render_slab_kernelILi0ELb1E",
    "render_repeats_raster": "render_raster_kernelILb0ELb1E",
    "render_batched_raster": "render_raster_kernelILb0ELb1E",
    "render_repeats_ratio": "render_slab_kernelILi2ELb1E",
    "render_batched_ratio": "render_slab_kernelILi2ELb1E",
    "pack_setups": "pack_setups_kernel",
    "render_repeats_raster_hoist": "render_raster_kernelILb1ELb1E",
    "render_batched_raster_hoist": "render_raster_kernelILb1ELb1E",
    "render_repeats_raster_mxu": "render_raster_mxu_kernelILb0ELb1E",
    "render_batched_raster_mxu": "render_raster_mxu_kernelILb0ELb1E",
    # K6: enum Chain in csrc/roofline.cu
    "roofline_fma_f32": "chain_f32_kernelILi0E", "roofline_fma_bf16": "chain_bf16_kernelILi1E",
    "roofline_mix_f32": "chain_f32_kernelILi2E", "roofline_mix_bf16": "chain_bf16_kernelILi3E",
    "roofline_recip_f32": "chain_f32_kernelILi4E", "roofline_div_f32": "chain_f32_kernelILi5E",
}


def ptxas_usage(log: str) -> dict:
    """``nvcc -Xptxas -v`` output → {mangled function: {registers,
    spill_bytes, stack_bytes}} (spill stores plus loads; the stack frame,
    local memory per thread)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = out.setdefault(m.group(1), {})
        elif current is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            if (m := re.search(r"(\d+) bytes stack frame", line)):
                current["stack_bytes"] = int(m.group(1))
        elif current is not None and (m := re.search(r"Used (\d+) registers", line)):
            current["registers"] = int(m.group(1))
    return out


def usage_of(usage: dict, name: str) -> dict:
    """A kernel's registers, spill bytes and stack frame from
    :func:`ptxas_usage` (None where the build log names no such
    function)."""
    fragment = PTXAS_NAMES.get(name)
    found = [v for k, v in usage.items() if fragment and fragment in k]
    return {key: found[0].get(key) if found else None
            for key in ("registers", "spill_bytes", "stack_bytes")}


def raw_launches(scene, renderer, rigid, force, poses, spr, n_push):
    """Closures that launch each kernel on prepared buffers through the
    package's launch functions, so that timing sees the kernels and not the
    wrappers' packing.  A hoisted renderer's render kernels read setup
    tables packed here once; its setup pass is timed on its own
    (``pack_setups``).  They count no launches."""
    e, reps = rigid.pos.shape[0], poses.shape[0]
    packed, force_t = soa.pack_state(rigid).contiguous(), force.t().contiguous()
    state_out, pose_out = torch.empty_like(packed), torch.empty_like(poses)
    poses_r = poses.contiguous()
    poses_b = raycast.poses_from_rigid(rigid)[None].contiguous()
    frames_r = torch.empty((e, reps, renderer.frame_width), dtype=torch.uint8, device=poses.device)
    frames_b = torch.empty((e, 1, renderer.frame_width), dtype=torch.uint8, device=poses.device)
    phys_p, render_p = cuda_step.phys_params(scene), renderer.kernel_params(scene)
    setups_r = setups_b = None
    raw = {}
    if renderer.hoist:
        setups_r, setups_b = (torch.empty((*p.shape[:2], renderer.setup_width), device=p.device)
                              for p in (poses_r, poses_b))
        renderer.launch_pack(render_p, poses_r, setups_r)
        renderer.launch_pack(render_p, poses_b, setups_b)
        raw["pack_setups"] = lambda: renderer.launch_pack(render_p, poses_r, setups_r)
    return {
        **raw,
        "step_repeats": lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, pose_out, reps, spr),
        "step_substeps": lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, None, 1, n_push),
        "render_repeats": lambda: renderer.launch(render_p, poses_r, frames_r, setups_r),
        "render_batched": lambda: renderer.launch(render_p, poses_b, frames_b, setups_b),
    }


def silhouette_stats(got: torch.Tensor, want: torch.Tensor, h: int, w: int) -> dict:
    """Frames (…, C·3·h·w) of a product-rounded render against another: the
    share of bytes that differ and how many differing pixels lie further
    than one pixel from an edge of more than SIL_EDGE levels in either."""
    g, v = (x.int().reshape(-1, h, w) for x in (got, want))

    def edges(img):
        e = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        d = (img[..., :, 1:] - img[..., :, :-1]).abs() > SIL_EDGE
        e[..., :, :-1] |= d
        e[..., :, 1:] |= d
        d = (img[..., 1:, :] - img[..., :-1, :]).abs() > SIL_EDGE
        e[..., :-1, :] |= d
        e[..., 1:, :] |= d
        return e

    zone = edges(g) | edges(v)
    near = zone.clone()
    near[..., :-1, :] |= zone[..., 1:, :]
    near[..., 1:, :] |= zone[..., :-1, :]
    near[..., :, :-1] |= zone[..., :, 1:]
    near[..., :, 1:] |= zone[..., :, :-1]
    diff = g != v
    return {"share_bytes_differing": float(diff.float().mean()),
            "differing_off_silhouette": int((diff & ~near).sum())}


def silhouette_check(name: str, got: torch.Tensor, want: torch.Tensor, h: int, w: int) -> dict:
    """:func:`silhouette_stats`, which must show under SIL_SHARE of bytes
    differing and every differing pixel on a silhouette; raises otherwise."""
    res = silhouette_stats(got, want, h, w)
    if res["differing_off_silhouette"] or res["share_bytes_differing"] >= SIL_SHARE:
        raise AssertionError(f"{name} breaks the silhouette rule: {res}")
    return res


def phys_parity(scene, rigid, force) -> tuple[dict, tuple]:
    """K1 and K2 against the plain version on the CPU → (max abs error by
    kernel, the plain K1's poses); raises where one disagrees.  PyTorch's
    CUDA rsqrt is approximate, which on its own moves the pole's spin ~1e-4
    off the exactly rounded result after 30 substeps."""
    spr, reps, n_push = CONFIG5.steps_per_repeat, CONFIG5.action_repeats, CONFIG5.initial_force_steps
    cpu = lambda st: st.map(lambda x: x.cpu())
    rigid_cpu, force_cpu = cpu(rigid), force.cpu()
    k2 = cuda_step.step_substeps(scene, rigid, force, n_push)
    p2 = soa.step_substeps_batched(scene, rigid_cpu, force_cpu, n_push)
    k1, k1_poses = cuda_step.step_repeats(scene, rigid, force, spr, reps)
    p1, p1_poses = soa.step_repeats_batched(scene, rigid_cpu, force_cpu, spr, reps)
    errs = {
        "step_repeats": max(state_err(cpu(k1), p1), float((k1_poses.cpu() - p1_poses).abs().max())),
        "step_substeps": state_err(cpu(k2), p2),
    }
    for name, err in errs.items():
        if not err <= PHYS_ATOL:
            raise AssertionError(f"{name} disagrees with its plain version: {err}")
    return errs, p1_poses


def parity(scene, renderer, rigid, force) -> tuple[dict, dict]:
    """Each kernel against its plain version on these inputs → (max abs
    error by kernel, pixel statistics by render kernel); raises where one
    disagrees.  K3 renders the poses of the plain K1."""
    errs, p1_poses = phys_parity(scene, rigid, force)
    poses = p1_poses.to(rigid.pos.device)
    pix = {
        "render_repeats": pixel_check(
            "render_repeats", renderer.render_repeats(scene, poses), renderer.plain(scene, poses)),
        "render_batched": pixel_check(
            "render_batched", renderer.render_batched(scene, rigid),
            renderer.plain(scene, raycast.poses_from_rigid(rigid)[None])[:, 0]),
    }
    errs.update({k: v["max_abs_err"] for k, v in pix.items()})
    torch.cuda.synchronize()
    return errs, pix


def parity_inputs(scene, device, e: int = PARITY_ENVS):
    """E states from a seed: the reset push then a few random steps (plain
    PyTorch), so contacts and tilts vary; plus a force for the next step."""
    g = torch.Generator(device=device).manual_seed(SEED)
    state, _ = cartpole.reset_batched(
        CONFIG5, scene, e, soa.step_substeps_batched,
        lambda s, r: torch.zeros((e, 1), device=device), device, generator=g)
    rigid = state.rigid
    for _ in range(3):
        force = 50.0 * (2.0 * torch.rand((e, 2), generator=g, device=device) - 1.0)
        force = torch.cat([force, torch.zeros((e, 1), device=device)], -1)
        rigid = soa.step_substeps_batched(scene, rigid, force, CONFIG5.steps_per_repeat * 3)
    force = 50.0 * (2.0 * torch.rand((e, 2), generator=g, device=device) - 1.0)
    force = torch.cat([force, torch.zeros((e, 1), device=device)], -1)
    return rigid, force


def raster_parity(scene, renderer, rigid, poses) -> dict:
    """K5a in both launch forms against the plain raster version on the
    card → pixel statistics by form; raises where one disagrees."""
    pix = {
        "render_repeats_raster": pixel_check(
            "render_repeats_raster", renderer.render_repeats(scene, poses),
            renderer.plain(scene, poses)),
        "render_batched_raster": pixel_check(
            "render_batched_raster", renderer.render_batched(scene, rigid),
            renderer.plain(scene, raycast.poses_from_rigid(rigid)[None])[:, 0]),
    }
    torch.cuda.synchronize()
    return pix


def mode_parity(scene, name, mode, cfg, rigid, poses) -> dict:
    """One mode of the render kernel in both launch forms against its plain
    version on the card → statistics by form; raises where one disagrees.
    The hoisted raster must equal its plain version and K5a byte for byte;
    the product's raster must keep the silhouette rule against both."""
    dev = rigid.pos.device
    rnd, k5a = Renderer(cfg, dev, **mode), Renderer(cfg, dev, raster=True)
    poses_b = raycast.poses_from_rigid(rigid)[None]
    forms = {
        "repeats": (rnd.render_repeats(scene, poses), rnd.plain(scene, poses),
                    k5a.render_repeats(scene, poses)),
        "batched": (rnd.render_batched(scene, rigid), rnd.plain(scene, poses_b)[:, 0],
                    k5a.render_batched(scene, rigid)),
    }
    out = {}
    for form, (got, plain, base) in forms.items():
        label = f"{name}_{form}"
        res = pixel_check(label, got, plain)
        if mode.get("raster"):
            res["max_abs_err_vs_k5a"] = pixel_check(label + "_vs_k5a", got, base)["max_abs_err"]
            if mode.get("mxu"):
                h, w = cfg.obs_height, cfg.obs_width
                res["silhouette_vs_plain"] = silhouette_check(label, got, plain, h, w)
                res["silhouette_vs_k5a"] = silhouette_check(label + "_vs_k5a", got, base, h, w)
            elif not (torch.equal(got, plain) and torch.equal(got, base)):
                raise AssertionError(f"{label} is not byte-equal to its plain version and K5a")
        out[form] = res
    torch.cuda.synchronize()
    return out


def params_of(*modules) -> list[torch.Tensor]:
    return [p.detach().clone() for m in modules for p in m.parameters()]


def target_step_err(t0, online, t1, tau) -> float:
    """‖t1 − (t0 + τ·(online − t0))‖ / ‖τ·(online − t0)‖ over all params, in
    float64: how far one update's target step is from the polyak step."""
    num = den = 0.0
    for a, o, b in zip(t0, online, t1):
        a, o, b = a.double(), o.double(), b.double()
        step = tau * (o - a)
        num += float(((b - a) - step).pow(2).sum())
        den += float(step.pow(2).sum())
    return math.sqrt(num / den) if den > 0 else math.inf


def bench_opts(**overrides) -> argparse.Namespace:
    """The bench's options (its defaults: utils/benchmark.py) for one row."""
    opts = benchmark.make_parser().parse_args([])
    for k, v in overrides.items():
        setattr(opts, k, v)
    return opts


def train_row(opts, row_kernels) -> tuple[dict, dict]:
    """Train one bench row at full width as the bench does: its
    ``build``, one warm segment, its timed windows and their best rate
    (``benchmark.timed_windows``, ``best_window``); then one more update
    outside the counted run to check the polyak step → (the row's line,
    what the later phases need)."""
    cfg = benchmark.bench_config(opts)
    e = opts.num_envs
    st, segment = benchmark.build(opts)
    actor0 = params_of(st.actor)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t_warm = time.monotonic()
    st, warm = segment(st)
    warm = {k: float(v) for k, v in warm.items()}
    warm_s = time.monotonic() - t_warm
    seen = []
    st, windows = benchmark.timed_windows(segment, st, opts, seen)
    launches = dict(kernels.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    seg_metrics = [{k: float(v) for k, v in m.items()} for m in seen]
    rate, _, rates = benchmark.best_window(windows, e * opts.steps_per_segment)
    actor_moved = max(float((a - b).abs().max()) for a, b in zip(actor0, params_of(st.actor)))

    train_once = ddpg.make_train_once(cfg, gamma=TRAIN_HP["gamma"], tau=TRAIN_HP["tau"],
                                      warmup_steps=TRAIN_HP["warmup_steps"])
    t0 = params_of(st.target_actor, st.target_critic)
    train_once(st, replay_mod.sample(st.replay, TRAIN_HP["batch_size"], st.generator),
               st.env_steps)
    step_err = target_step_err(t0, params_of(st.actor, st.critic),
                               params_of(st.target_actor, st.target_critic), TRAIN_HP["tau"])

    mean = lambda k: sum(m[k] for m in seg_metrics) / len(seg_metrics)
    trained = [m for m in seg_metrics if m["updates"] > 0]
    checks = {
        "row_kernels_launched": all(launches[k] > 0 for k in row_kernels),
        "other_render_mode_not_launched": all(
            v == 0 for k, v in launches.items()
            if k.startswith(("render", "pack")) and k not in row_kernels),
        "losses_finite": all(math.isfinite(m[k]) for m in [warm, *seg_metrics]
                             for k in ("critic_loss", "actor_loss")),
        "critic_loss_positive_once_trained": bool(trained)
        and all(m["critic_loss"] > 0.0 for m in trained),
        "actor_moved": actor_moved > 0.0,
        "target_moved_by_tau": step_err < TARGET_STEP_RTOL,
        "replay_full": st.replay.size == st.replay.capacity,
    }
    config = dict(use_raw_pixels=False)
    if cfg.use_raw_pixels:
        config = dict(num_cameras=cfg.num_cameras, obs_samples=cfg.obs_samples,
                      obs_pool=cfg.obs_pool, raster=cfg.obs_samples == 0)
    line = dict(
        envs=e, config=config,
        render_options={k: getattr(opts, k) for k in (
            "render_raster", "render_recip", "raster_hoist", "render_mxu")},
        hyperparameters={**TRAIN_HP, "replay_capacity": opts.replay_capacity},
        warm_segment_s=warm_s, min_wall_s=opts.min_wall_s,
        window_s=[t for _, t in windows], window_segments=[n for n, _ in windows],
        window_env_steps_per_s=rates, env_steps_per_s=rate,
        spread=(max(rates) - min(rates)) / rate, step_ms=1e3 * e / rate,
        mean_critic_loss=mean("critic_loss"), mean_actor_loss=mean("actor_loss"),
        mean_reward=mean("reward"), mean_done_frac=mean("done_frac"),
        double_reset_frac=mean("double_reset_frac"), warm_segment=warm,
        updates=sum(m["updates"] for m in seg_metrics) + int(warm["updates"]),
        replay_size=st.replay.size, replay_cursor=st.replay.cursor,
        replay_capacity=st.replay.capacity, env_steps=st.env_steps,
        actor_max_param_change=actor_moved, target_step_rel_err=step_err,
        launches=launches, peak_mem_mib=peak_mib, checks=checks,
    )
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: {checks}")
    return line, {"state": st, "segment": lambda st: segment(st)[1],
                  "step_ms": 1e3 * e / rate, "launches": launches}


def bytes_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same float32 bits."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def lowdim_parity(scene, venv, rigid, force, name: str) -> dict:
    """The low-dim step (one K1 launch, frames read from its poses) against
    the JAX venv's per-repeat composition run through the port's kernels
    (K2 per repeat, then ``observe_lowdim``): frames and states byte-equal;
    and within PHYS_ATOL of the plain composition on the CPU.  Raises where
    one disagrees."""
    cfg = venv.config
    k1_rigid, k1_obs = venv.sim_fn(scene, rigid, force)
    k2_rigid, k2_obs = cartpole.simulate_repeats(cfg, scene, rigid, force, cuda_step.step_substeps,
                                                 cartpole.observe_lowdim)
    byte_equal = {"frames": bytes_equal(k1_obs, k2_obs),
                  **{f: bytes_equal(getattr(k1_rigid, f), getattr(k2_rigid, f))
                     for f in ("pos", "quat", "vel", "ang")}}
    cpu = lambda st: st.map(lambda x: x.cpu())
    p_rigid, p_obs = cartpole.simulate_repeats(cfg, scene, cpu(rigid), force.cpu(),
                                               soa.step_substeps_batched, cartpole.observe_lowdim)
    err = max(state_err(cpu(k1_rigid), p_rigid), float((k1_obs.cpu() - p_obs).abs().max()))
    if not all(byte_equal.values()):
        raise AssertionError(f"{name}: K1's low-dim step is not byte-equal to K2 per repeat + "
                             f"observe_lowdim: {byte_equal}")
    if not err <= PHYS_ATOL:
        raise AssertionError(f"{name}: the low-dim step is {err} off the plain composition")
    return {"envs": rigid.pos.shape[0], "obs_shape": list(k1_obs.shape),
            "byte_equal_to_k2_per_repeat": byte_equal, "max_abs_err_vs_plain_cpu": err}


def run_group(argv: list, timeout_s: float, cwd: str) -> tuple[int, str, str]:
    """Run ``argv`` in a process group of its own → (rc, stdout, stderr);
    at ``timeout_s`` the whole group (the bench and its row children) is
    killed and TimeoutError raised."""
    proc = subprocess.Popen(argv, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise TimeoutError(f"{argv} killed after {timeout_s:.0f} s:\n{out}\n{err[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out, err


def bench_check(out: str) -> tuple[list, dict, dict]:
    """The bench suite's stdout → (row lines, summary line, checks): four
    row lines in ROW_SPECS' order, then the summary last; every row on
    ``cuda`` with a value > 0, its card and power limit; the low-dim row's
    metric without ``_pixel_render``, the others with it; every ceiling the
    row's measured mix rate over the census of its config."""
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    rows, summary = lines[:-1], lines[-1] if lines else {}
    defaults = benchmark.make_parser().parse_args([])

    def ceiling_ok(row, overrides) -> bool:
        ns = SimpleNamespace(**{**vars(defaults), **overrides,
                                "render_raster": row["_render_raster"]})
        mix = row.get("_mix_ops_per_s")
        return (isinstance(mix, float) and math.isfinite(mix) and mix > 0
                and row["_census_ops_per_step"] == benchmark.census_ops_per_step(ns)
                and row["ceiling"] == round(benchmark.census_ceiling(ns, mix), 1))

    specs = benchmark.ROW_SPECS
    paired = list(zip(rows, specs))
    checks = {
        "four_rows_then_summary": len(rows) == len(specs)
        and [r.get("config") for r in rows] == [label for label, _, _ in specs]
        and "rows" in summary,
        "all_cuda": all(r.get("_backend") == "cuda" and r.get("_device")
                        and r.get("_power_limit") for r in rows),
        "values_positive": all(r.get("value", 0) > 0 for r in rows),
        "lowdim_not_pixel_render": all(
            ("_pixel_render" in r["metric"]) != bool(over.get("lowdim"))
            for r, (_, _, over) in paired),
        "ceilings_from_measured_mix": all(ceiling_ok(r, over) for r, (_, _, over) in paired),
        "summary_without_error": bool(rows) and "error" not in summary
        and summary.get("metric") == rows[0]["metric"] + specs[0][1],
    }
    return rows, summary, checks


def training_profile(st, segment, step_ms: float) -> dict:
    """Device time per env step of one profiled training segment, split
    into the port's kernels (by name), the learner (kernels launched by an
    op inside a ``ddpg.LEARNER_SPAN`` span: GEMMs, Adam, target updates,
    sampling) and the rest; plus the busy share against the unprofiled
    step time."""
    steps = TRAIN_HP["steps_per_segment"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        {k: float(v) for k, v in segment(st).items()}
        torch.cuda.synchronize()
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == ddpg.LEARNER_SPAN and not str(e.device_type).endswith("CUDA")]
    learner_us = 0.0
    for e in events:
        ks = getattr(e, "kernels", None) or []
        if ks and not str(e.device_type).endswith("CUDA") and any(
                a <= e.time_range.start <= b for a, b in spans):
            learner_us += sum(k.duration for k in ks)
    by_name = {}
    for e in device_events(prof):
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    total_us = sum(by_name.values())
    ours_us = sum(v for k, v in by_name.items() if any(n in k for n in benchmark.PORT_KERNELS))
    per_step = lambda us: us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        device_ms_per_step=per_step(total_us), kernels_ms_per_step=per_step(ours_us),
        learner_ms_per_step=per_step(learner_us) if spans else None,
        rest_ms_per_step=per_step(total_us - ours_us - learner_us) if spans else None,
        learner_spans=len(spans), step_ms=step_ms,
        device_busy_share=per_step(total_us) / step_ms if total_us else None,
        learner_share_of_device=learner_us / total_us if total_us and spans else None,
        top_device_ms_per_step={k: per_step(v) for k, v in top},
    )


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        return run()
    finally:
        faulthandler.cancel_dump_traceback_later()


def run() -> int:
    t0 = time.monotonic()
    last = [t0]

    def emit(phase: str, **fields):
        now = time.monotonic()
        print(json.dumps({"phase": phase, "elapsed_s": round(now - t0, 3),
                          "phase_s": round(now - last[0], 3), **fields}), flush=True)
        last[0] = now

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    info = kernels.build()
    kernels.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", nvcc_s=round(info["nvcc_s"], 3), built=info["built"], ptxas=ptxas)

    # 3. parity: each kernel against its plain version on seeded states
    scene = cartpole.scene_for(CONFIG5)
    renderer = Renderer(CONFIG5, dev)
    rigid, force = parity_inputs(scene, dev)
    seeded_errs, pix = parity(scene, renderer, rigid, force)
    # The plain version on the card against itself on the CPU, for scale.
    plain_gap = state_err(
        soa.step_substeps_batched(scene, rigid, force, CONFIG5.initial_force_steps).map(lambda x: x.cpu()),
        soa.step_substeps_batched(scene, rigid.map(lambda x: x.cpu()), force.cpu(),
                                  CONFIG5.initial_force_steps))
    emit("parity", envs=PARITY_ENVS, physics_atol=PHYS_ATOL,
         step_substeps_max_abs_err=seeded_errs["step_substeps"],
         step_repeats_max_abs_err=seeded_errs["step_repeats"],
         plain_cuda_vs_cpu_step_substeps_max_abs_err=plain_gap, **pix)

    # 4. K5a against the plain raster version: the 1cam_exact row's own
    # reset state and first step under a seeded actor, and seeded states
    # seen by 2 cameras (the TD3 recipe's camera count).
    spr, reps, n_push = CONFIG5.steps_per_repeat, CONFIG5.action_repeats, CONFIG5.initial_force_steps
    venv1 = make_venv(CONFIG1_EXACT, NUM_ENVS)
    raster1 = Renderer(CONFIG1_EXACT, dev, raster=True)
    actor1 = Actor(CONFIG1_EXACT.obs_shape, use_raw_pixels=True, height=CONFIG1_EXACT.obs_height,
                   width=CONFIG1_EXACT.obs_width, generator=torch.Generator().manual_seed(SEED))
    gen1 = torch.Generator(device=dev).manual_seed(SEED)
    state1, obs1 = venv1.reset(gen1)
    rigid1 = state1.rigid
    with torch.no_grad():
        force1 = cartpole.action_to_force(CONFIG1_EXACT, actor1(obs1))
    _, poses1 = cuda_step.step_repeats(scene, rigid1, force1, spr, reps)
    pix_main = raster_parity(scene, raster1, rigid1, poses1)
    raster2 = Renderer(CONFIG2_EXACT, dev, raster=True)
    _, poses_seeded = soa.step_repeats_batched(scene, rigid, force, spr, reps)
    pix_2cam = raster_parity(scene, raster2, rigid, poses_seeded)
    raster_errs = {k: v["max_abs_err"] for k, v in pix_main.items()}
    seeded_errs.update({k: v["max_abs_err"] for k, v in pix_2cam.items()})
    emit("parity_raster", envs_1cam_exact=NUM_ENVS, envs_2cam_exact=PARITY_ENVS,
         pixel_bound={"level": PIX_LEVEL, "share": PIX_SHARE, "mean": PIX_MEAN},
         one_cam_exact=pix_main, two_cam_exact=pix_2cam)

    # 4b. K5b, K5c and K5d against their plain versions: the main path's
    # 4096-env inputs (config 5's reset state and first step for the ratio
    # slab, the 1cam_exact row's for the raster modes) and the seeded
    # states seen by 2 cameras.
    venv = make_venv(CONFIG5, NUM_ENVS)
    actor = Actor(CONFIG5.obs_shape, use_raw_pixels=True, height=CONFIG5.obs_height,
                  width=CONFIG5.obs_width, generator=torch.Generator().manual_seed(SEED))
    act = greedy_act(actor)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state5, obs5 = venv.reset(gen)
    rigid5 = state5.rigid
    with torch.no_grad():
        force5 = cartpole.action_to_force(CONFIG5, act(obs5))
    _, poses5 = cuda_step.step_repeats(scene, rigid5, force5, spr, reps)
    mode_inputs = {CONFIG5: (rigid5, poses5), CONFIG1_EXACT: (rigid1, poses1)}
    pix_modes, mode_errs = {}, {}
    for name, mode, cfg in MODES:
        seeded_cfg = CONFIG5 if cfg is CONFIG5 else CONFIG2_EXACT
        pix_modes[name] = {
            "main_path": mode_parity(scene, name, mode, cfg, *mode_inputs[cfg]),
            "seeded_2cam": mode_parity(scene, name, mode, seeded_cfg, rigid, poses_seeded),
        }
        suffix = Renderer(cfg, dev, **mode).suffix
        for form, launch in (("repeats", "render_repeats"), ("batched", "render_batched")):
            mode_errs[launch + suffix] = pix_modes[name]["main_path"][form]["max_abs_err"]
            seeded_errs[launch + suffix] = pix_modes[name]["seeded_2cam"][form]["max_abs_err"]
    # K5c's setup pass alone: its packed table byte-equal to the plain
    # packing (the same operations, rounded as written).
    for key, p_in, errs_to in (("main_path", poses1, mode_errs),
                               ("seeded_2cam", poses_seeded, seeded_errs)):
        hoisted = Renderer(CONFIG1_EXACT if key == "main_path" else CONFIG2_EXACT, dev,
                           raster=True, hoist=True)
        table = torch.empty((*p_in.shape[:2], hoisted.setup_width), device=dev)
        hoisted.launch_pack(hoisted.kernel_params(scene), p_in.contiguous(), table)
        want = raycast.pack_setups(scene, hoisted.cam_meta, p_in)
        err = float((table - want).abs().max())
        if not torch.equal(table.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"pack_setups is not byte-equal to its plain version: {err}")
        errs_to["pack_setups"] = err
        pix_modes["raster_hoist"][key]["pack_setups_byte_equal"] = True
    emit("parity_modes", envs_main_path=NUM_ENVS, envs_seeded=PARITY_ENVS,
         pixel_bound={"level": PIX_LEVEL, "share": PIX_SHARE, "mean": PIX_MEAN},
         silhouette_rule={"share": SIL_SHARE, "edge_levels": SIL_EDGE}, modes=pix_modes)

    # 4c. Shapes the card had not run: K3/K4 at one sample per pooled pixel
    # (the 1cam_samples1 row's reset state and first step), K1/K2 at 8192
    # envs against the plain version on the CPU.
    venv_s1 = make_venv(CONFIG1_S1, NUM_ENVS)
    state_s1, obs_s1 = venv_s1.reset(gen1)
    with torch.no_grad():
        force_s1 = cartpole.action_to_force(CONFIG1_S1, actor1(obs_s1))
    _, poses_s1 = cuda_step.step_repeats(scene, state_s1.rigid, force_s1, spr, reps)
    slab_s1 = Renderer(CONFIG1_S1, dev)
    pix_s1 = {
        "render_repeats": pixel_check("render_repeats_p2_1", slab_s1.render_repeats(scene, poses_s1),
                                      slab_s1.plain(scene, poses_s1)),
        "render_batched": pixel_check(
            "render_batched_p2_1", slab_s1.render_batched(scene, state_s1.rigid),
            slab_s1.plain(scene, raycast.poses_from_rigid(state_s1.rigid)[None])[:, 0]),
    }
    phys_8k, _ = phys_parity(scene, *parity_inputs(scene, dev, OWED_PHYS_ENVS))
    phys_ragged, _ = phys_parity(scene, *parity_inputs(scene, dev, RAGGED_ENVS))
    # K3/K4 on poses chosen to break the slab kernel's cull: the eye inside a
    # slab, a pole lying flat, a cart at the frame's border, a pole tip at
    # the camera plane, anything anywhere (raycast.cull_probe_poses).
    probe = raycast.cull_probe_poses(PROBE_POSES, SEED).to(dev)
    pix_probe = {
        "render_repeats": pixel_check("render_repeats_probe", renderer.render_repeats(
            scene, probe[None]), renderer.plain(scene, probe[None])),
        "render_batched": pixel_check("render_batched_probe", renderer.render_batched(
            scene, probe_rigid(probe)), renderer.plain(scene, probe[None])[:, 0]),
    }
    other_errs = {
        "step_repeats": {f"{OWED_PHYS_ENVS}_envs": phys_8k["step_repeats"],
                         f"{RAGGED_ENVS}_envs": phys_ragged["step_repeats"]},
        "step_substeps": {f"{OWED_PHYS_ENVS}_envs": phys_8k["step_substeps"],
                          f"{RAGGED_ENVS}_envs": phys_ragged["step_substeps"]},
        **{k: {"p2_1": pix_s1[k]["max_abs_err"], "adversarial": pix_probe[k]["max_abs_err"]}
           for k in ("render_repeats", "render_batched")},
    }
    # The cull of K3/K4 and of K5b where it could fail, and frames too large
    # to stage 3 repeats of in shared memory (config 5 at 192 x 192:
    # straight to global memory; one camera unpooled at 124 x 124: one
    # repeat per block), on the probe's poses as 3 repeats.
    cull = {"seeded": slab_cull_checks(scene, CONFIG5, poses_seeded, "seeded"),
            "p2_1": slab_cull_checks(scene, CONFIG1_S1, poses_s1, "p2_1"),
            "adversarial": slab_cull_checks(scene, CONFIG5, probe[None], "adversarial")}
    probe3 = probe[: 3 * LARGE_FRAME_ENVS].reshape(3, LARGE_FRAME_ENVS, 16)
    large = {}
    for key, cfg in (("config5_192", CONFIG5_WIDE), ("1cam_unpooled_124", CONFIG1_UNPOOLED)):
        rnd = Renderer(cfg, dev)
        large[key] = dict(
            blocking=dict(zip(("reps", "staged"), slab_blocking(rnd.num_cams, rnd.n, 3))),
            render_repeats=pixel_check(f"render_repeats_{key}", rnd.render_repeats(scene, probe3),
                                       rnd.plain(scene, probe3)),
            cull=slab_cull_checks(scene, cfg, probe3, key))
        other_errs["render_repeats"][key] = large[key]["render_repeats"]["max_abs_err"]
    emit("parity_owed", physics_atol=PHYS_ATOL,
         one_cam_samples1=dict(envs=NUM_ENVS, p2=slab_s1.p2, n=slab_s1.n, **pix_s1),
         physics=dict(envs=OWED_PHYS_ENVS, step_substeps_max_abs_err=phys_8k["step_substeps"],
                      step_repeats_max_abs_err=phys_8k["step_repeats"]),
         physics_ragged=dict(envs=RAGGED_ENVS,
                             step_substeps_max_abs_err=phys_ragged["step_substeps"],
                             step_repeats_max_abs_err=phys_ragged["step_repeats"]),
         adversarial=dict(envs=PROBE_POSES, **pix_probe), cull=cull,
         large_frames=dict(envs=LARGE_FRAME_ENVS, **large))
    del venv_s1, state_s1, obs_s1

    # 4d. K5a's and K5d's cull where it could fail: the 1cam_exact row's
    # main-path poses, the seeded states seen by 2 cameras, the probe's
    # poses seen by 1 and by 2 cameras, and a frame over the shared memory
    # left for staging (2 cameras exact at 192 x 192, written straight to
    # global memory).
    raster_cull = {
        "main_path": raster_cull_check(scene, CONFIG1_EXACT, poses1, "main_path"),
        "seeded_2cam": raster_cull_check(scene, CONFIG2_EXACT, poses_seeded, "seeded_2cam"),
        "probe_1cam": raster_cull_check(scene, CONFIG1_EXACT, probe[None], "probe_1cam"),
        "probe_2cam": raster_cull_check(scene, CONFIG2_EXACT, probe[None], "probe_2cam"),
        "2cam_exact_192": raster_cull_check(scene, CONFIG2_EXACT_WIDE, probe3, "2cam_exact_192"),
    }
    wide = Renderer(CONFIG2_EXACT_WIDE, dev, raster=True)
    blocking = dict(zip(("reps", "staged"),
                        slab_blocking(wide.num_cams, wide.n, 3, RASTER_FRAME_BYTES)))
    if blocking["staged"]:
        raise AssertionError("2cam_exact_192: expected a frame too large to stage")
    emit("parity_raster_cull", envs_main_path=NUM_ENVS, envs_seeded=PARITY_ENVS,
         envs_probe=PROBE_POSES, envs_large=LARGE_FRAME_ENVS, large_blocking=blocking,
         sets=raster_cull)

    # 5. acting main path at config 5, full width
    with torch.no_grad():  # the actor's first call sets up cuBLAS: keep it out of the timing
        act(venv.reset(gen)[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    eval_rates, episodes = [], []
    for _ in range(EVAL_ROLLOUTS):
        t_eval = time.monotonic()
        mean_len, mean_rew = eval_rollout(venv, act, gen)
        episodes.append((float(mean_len), float(mean_rew)))
        eval_rates.append(NUM_ENVS * CONFIG5.max_episode_len / (time.monotonic() - t_eval))
    eval_rates.sort()
    with torch.no_grad():
        states, obs = venv.reset(gen)
        pool = (states, obs)
        done = torch.zeros((NUM_ENVS,), dtype=torch.bool, device=dev)
        reward_sum = torch.zeros((NUM_ENVS,), device=dev)
        torch.cuda.synchronize()
        window_s = []
        for _ in range(SIM_ONLY_WINDOWS):
            t_sim = time.monotonic()
            for _ in range(SIM_ONLY_STEPS):
                obs_in = resolve_obs(done, pool[1], obs)
                states, obs, reward, done = venv.step_lazy(states, act(obs_in), reset_pool=pool)
                reward_sum += reward
            torch.cuda.synchronize()
            window_s.append(time.monotonic() - t_sim)
    sim_rates = sorted(NUM_ENVS * SIM_ONLY_STEPS / t for t in window_s)
    sim_rate = sim_rates[len(sim_rates) // 2]
    launches = dict(kernels.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    checks = {
        "launches_all_positive": all(launches[k] > 0 for k, _, _ in KERNELS[:4]),
        "other_render_mode_not_launched": all(
            v == 0 for k, v in launches.items()
            if k.startswith(("render", "pack")) and k not in ("render_repeats", "render_batched")),
        "finite": all(math.isfinite(v) for ep in episodes for v in ep)
        and bool(torch.isfinite(reward_sum).all())
        and all(bool(torch.isfinite(getattr(states.rigid, f)).all())
                for f in ("pos", "quat", "vel", "ang")),
        "episode_len_in_range": all(1.0 <= ep[0] <= CONFIG5.max_episode_len for ep in episodes),
        "obs_shape": tuple(obs.shape) == (NUM_ENVS,) + CONFIG5.pixel_obs_shape
        and obs.dtype == torch.uint8,
        "obs_not_blank": int(obs.max()) > int(obs.min()),
    }
    emit("main_path", envs=NUM_ENVS, eval_steps=CONFIG5.max_episode_len,
         eval_env_steps_per_s=eval_rates[len(eval_rates) // 2], eval_rollout_rates=eval_rates,
         sim_only_windows_s=window_s, sim_only_steps_per_window=SIM_ONLY_STEPS,
         sim_only_env_steps_per_s=sim_rate, sim_only_window_rates=sim_rates,
         sim_only_spread=(sim_rates[-1] - sim_rates[0]) / sim_rate,
         mean_episode_len=[ep[0] for ep in episodes],
         mean_episode_reward=[ep[1] for ep in episodes],
         sim_only_mean_reward=float(reward_sum.mean()) / (SIM_ONLY_WINDOWS * SIM_ONLY_STEPS),
         launches=launches,
         peak_mem_mib=peak_mib, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"main path checks failed: {checks}")
    launches_by_path = {"acting_2cam_samples2": launches}

    # 6. DDPG training at each row, full width, the bench's hyperparameters
    trained = {}
    for name, overrides, row_kernels in TRAIN_ROWS:
        line, trained[name] = train_row(bench_opts(num_envs=NUM_ENVS, **overrides), row_kernels)
        launches_by_path[f"train_{name}"] = line["launches"]
        emit(f"train_{name}", **line)

    # Poses from the end of the config-5 training row: its env states after
    # the timed windows, stepped once under the seeded actor.
    st5 = trained["2cam_samples2"]["state"]
    with torch.no_grad():
        force_te = cartpole.action_to_force(CONFIG5, act(st5.obs))
    _, poses_te = soa.step_repeats_batched(scene, st5.env_states.rigid, force_te, spr, reps)
    pix_te = pixel_check("render_repeats_training_end", renderer.render_repeats(scene, poses_te),
                         renderer.plain(scene, poses_te))
    cull["training_end"] = slab_cull_checks(scene, CONFIG5, poses_te, "training_end")
    other_errs["render_repeats"]["training_end"] = pix_te["max_abs_err"]
    # The raster cull on poses from the end of the 1cam_exact training row,
    # stepped once under its seeded actor.
    st1 = trained["1cam_exact"]["state"]
    with torch.no_grad():
        force_te1 = cartpole.action_to_force(CONFIG1_EXACT, actor1(st1.obs))
    _, poses_te1 = soa.step_repeats_batched(scene, st1.env_states.rigid, force_te1, spr, reps)
    raster_cull["training_end"] = raster_cull_check(scene, CONFIG1_EXACT, poses_te1,
                                                    "training_end")
    emit("parity_training_end", envs=NUM_ENVS, render_repeats=pix_te, cull=cull["training_end"],
         raster_cull=raster_cull["training_end"])

    # 7. one TD3 segment at the 1cam_exact row
    td3_opts = SimpleNamespace(seed=SEED, replay_capacity=REPLAY_CAPACITY, twin_critic=True)
    td3_state = ddpg.init_state(td3_opts, CONFIG1_EXACT, venv1)
    td3_segment = ddpg.make_segment(venv1, **TRAIN_HP, **TD3_HP)
    kernels.reset_launches()
    t_td3 = time.monotonic()
    td3 = {k: float(v) for k, v in td3_segment(td3_state).items()}
    td3_s = time.monotonic() - t_td3
    launches_by_path["td3_1cam_exact"] = dict(kernels.LAUNCHES)
    td3_checks = {
        "losses_finite": all(math.isfinite(td3[k]) for k in ("critic_loss", "actor_loss")),
        "updated": td3["updates"] > 0,
        "twin": isinstance(td3_state.critic, ddpg.TwinCritic),
    }
    emit("td3_1cam_exact", hyperparameters={**TRAIN_HP, **TD3_HP}, segment_s=td3_s,
         metrics=td3, launches=launches_by_path["td3_1cam_exact"], checks=td3_checks)
    if not all(td3_checks.values()):
        raise AssertionError(f"td3 checks failed: {td3_checks}")
    del td3_state, td3_segment

    # 7a. the low-dim path at 8192 envs (the bench's fourth row): K1's
    # frames and states byte-equal to K2 per repeat + observe_lowdim on the
    # main path's reset states under a seeded actor and on seeded states,
    # then a training row with the bench's hyperparameters.
    opts_ld = bench_opts(lowdim=True, num_envs=LOWDIM_ENVS)
    cfg_ld = benchmark.bench_config(opts_ld)
    venv_ld = make_venv(cfg_ld, LOWDIM_ENVS)
    actor_ld = Actor(cfg_ld.obs_shape, generator=torch.Generator().manual_seed(SEED))
    state_ld, obs_ld = venv_ld.reset(torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        force_ld = cartpole.action_to_force(cfg_ld, actor_ld(obs_ld))
    scene_ld = venv_ld.scene
    ld_parity = {
        "main_path": lowdim_parity(scene_ld, venv_ld, state_ld.rigid, force_ld, "main_path"),
        "seeded": lowdim_parity(scene_ld, venv_ld, *parity_inputs(scene_ld, dev, LOWDIM_ENVS),
                                "seeded"),
    }
    # K1 and K2 at the low-dim path's 8192 envs, launched on prepared
    # buffers as in the kernels line.
    packed = soa.pack_state(state_ld.rigid).contiguous()
    state_out, force_t = torch.empty_like(packed), force_ld.t().contiguous()
    poses_ld = torch.empty((cfg_ld.action_repeats, LOWDIM_ENVS, cuda_step.POSE_COLS),
                           device=dev)
    phys_p = cuda_step.phys_params(scene_ld)
    ld_ms = {
        "step_repeats": time_ms(lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, poses_ld, cfg_ld.action_repeats,
            cfg_ld.steps_per_repeat), reps=50),
        "step_substeps": time_ms(lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, None, 1, cfg_ld.initial_force_steps),
            reps=50),
    }
    line, trained["lowdim"] = train_row(opts_ld, _PHYS)
    launches_by_path["train_lowdim"] = line["launches"]
    emit("lowdim", parity=ld_parity, kernel_ms_8192_envs=ld_ms, **line)
    del state_ld, obs_ld

    # 7b. the card's element-op rate (K6): each chain against its plain
    # version, then timed at N and 2N iterations
    k6_errs, k6_moved = {}, {}
    for mix, (_, _, dtype) in roofline.CHAINS.items():
        x = roofline.varied(mix, roofline.SHAPE, dev)
        want = roofline.plain_chain(mix, x, K6_PARITY_ITERS, fused=True).float()
        err = float((roofline.run_chain(mix, x, K6_PARITY_ITERS).float() - want).abs().max())
        moved = float((want - x.float()).abs().max())
        if not err <= min(K6_ATOL[dtype], K6_MOVE_SHARE * moved):
            raise AssertionError(
                f"roofline {mix} disagrees with its plain version: {err} (plain moved {moved})")
        k6_errs[f"roofline_{mix}"], k6_moved[mix] = err, moved
    kernels.reset_launches()
    probe = {mix: roofline.measure_chain(mix) for mix in roofline.CHAINS}
    launches_by_path["roofline"] = dict(kernels.LAUNCHES)
    # fma_f32's chain must be FFMAs only (no FMUL/FADD pair, nothing folded);
    # checked where the toolkit has cuobjdump.
    fma_sass = sass_opcodes(kernels.build()["path"], "chain_f32_kernelILi0E")
    if fma_sass is None:
        print("chip_smoke: no cuobjdump; fma_f32's SASS is not checked", file=sys.stderr)
    elif not (fma_sass.get("FFMA", 0) > 0 and not fma_sass.get("FMUL") and not fma_sass.get("FADD")):
        raise AssertionError(f"fma_f32's chain is not FFMAs only: {fma_sass}")
    peak = {m: PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else PEAK_F32_OPS_PER_S
            for m, (_, _, dtype) in roofline.CHAINS.items()}
    emit("roofline", shape=roofline.SHAPE, iters=roofline.ITERS, card=smi,
         fma_f32_sass_opcodes=fma_sass, fma_f32_sass_checked=fma_sass is not None,
         parity_iters=K6_PARITY_ITERS, max_abs_err=k6_errs, plain_moved=k6_moved,
         chains=probe, peak_ops_per_s=peak,
         share_of_peak={m: v["el_ops_per_s"] / peak[m] for m, v in probe.items()},
         launches={k: v for k, v in launches_by_path["roofline"].items() if v})

    # 8. kernels at the main paths' shapes: parity, time, plain time, bound
    e = NUM_ENVS
    state0, obs0 = venv.reset(gen)
    rigid0 = state0.rigid
    with torch.no_grad():
        force0 = cartpole.action_to_force(CONFIG5, act(obs0))
    errs, pix = parity(scene, renderer, rigid0, force0)
    emit("parity_main_path", envs=NUM_ENVS, physics_atol=PHYS_ATOL,
         step_substeps_max_abs_err=errs["step_substeps"],
         step_repeats_max_abs_err=errs["step_repeats"], **pix)
    errs.update(raster_errs)
    errs.update(mode_errs)
    errs.update(k6_errs)
    _, poses0 = cuda_step.step_repeats(scene, rigid0, force0, spr, reps)
    cull["main_path"] = slab_cull_checks(scene, CONFIG5, poses0, "main_path")
    raster_main = raster_cull["main_path"]
    skipped_main = {"": cull["main_path"]["k3"]["skipped_cast_share"],
                    "_ratio": cull["main_path"]["k5b"]["skipped_cast_share"],
                    "_raster": raster_main["k5a"]["skipped_cast_share"],
                    "_raster_hoist": raster_main["k5c"]["skipped_cast_share"],
                    "_raster_mxu": raster_main["k5d"]["skipped_cast_share"]}
    # Every render kernel culls, so its work depends on the data: its bound
    # is the census of the work these inputs need (needed_plain), the
    # full-work census beside it.
    full_ops = {}
    # name → (wrapper call or None, plain version, bytes, operations or None
    # for the census of the plain version)
    work = {
        "step_repeats": (
            lambda: cuda_step.step_repeats(scene, rigid0, force0, spr, reps),
            lambda: soa.step_repeats_batched(scene, rigid0, force0, spr, reps),
            (26 + 3 + 26 + reps * 16) * 4 * e, None),
        "step_substeps": (
            lambda: cuda_step.step_substeps(scene, rigid0, force0, n_push),
            lambda: soa.step_substeps_batched(scene, rigid0, force0, n_push),
            (26 + 3 + 26) * 4 * e, None),
    }
    raw = raw_launches(scene, renderer, rigid0, force0, poses0, spr, n_push)
    # Each render mode at its main path's inputs: K3/K4 and K5b at config
    # 5's, K5a, K5c and K5d at the 1cam_exact row's (the hoisted raster
    # with its product is held in parity_modes only: no row runs it).
    renderers = [(renderer, rigid0, poses0), (raster1, rigid1, poses1)]
    for _, mode, cfg in MODES[:3]:
        renderers.append((Renderer(cfg, dev, **mode), *mode_inputs[cfg]))
    for rnd, rig, pos in renderers:
        suffix = rnd.suffix
        # K5c and K5d compute K5a's frames: their bound is K5a's census, not
        # that of K5d's product, five of whose eight K columns are zero.
        ops_rnd = raster1 if rnd.raster else rnd
        frame_bytes, ray_bytes = rnd.frame_width, rnd.planes.numel() * 4
        # The hoisted render kernel reads its setup table, not the poses,
        # and computes no setup; its setup pass is a row of its own.
        in_width = rnd.setup_width if rnd.hoist else 16
        pack_ops = lambda pos, rnd=rnd: census(
            lambda: raycast.pack_setups(scene, rnd.cam_meta, pos)) if rnd.hoist else 0
        pos_b = raycast.poses_from_rigid(rig)[None]
        full_ops["render_repeats" + suffix] = census(
            lambda rnd=ops_rnd, pos=pos: rnd.plain(scene, pos)) - pack_ops(pos)
        full_ops["render_batched" + suffix] = census(
            lambda rnd=ops_rnd, pos_b=pos_b: rnd.plain(scene, pos_b)) - pack_ops(pos_b)
        needed = needed_plain(scene, ops_rnd, pos), needed_plain(scene, ops_rnd, pos_b)
        for fn, p_in in zip(needed, (pos, pos_b)):
            if not torch.equal(fn(), ops_rnd.plain(scene, p_in)):
                raise AssertionError("needed_plain's frames differ from the plain version")
        ops_r, ops_b = census(needed[0]) - pack_ops(pos), census(needed[1]) - pack_ops(pos_b)
        work["render_repeats" + suffix] = (
            lambda rnd=rnd, pos=pos: rnd.render_repeats(scene, pos),
            lambda rnd=rnd, pos=pos: rnd.plain(scene, pos),
            reps * e * in_width * 4 + ray_bytes + e * reps * frame_bytes, ops_r)
        work["render_batched" + suffix] = (
            lambda rnd=rnd, rig=rig: rnd.render_batched(scene, rig),
            lambda rnd=rnd, pos_b=pos_b: rnd.plain(scene, pos_b),
            e * in_width * 4 + ray_bytes + e * frame_bytes, ops_b)
        if suffix:
            mode_raw = raw_launches(scene, rnd, rig, force0, pos, spr, n_push)
            raw.update({k + suffix: v for k, v in mode_raw.items() if k.startswith("render")})
        if rnd.hoist:
            raw["pack_setups"] = mode_raw["pack_setups"]
            one = pos[:1, :1].contiguous()
            one_table = torch.empty((1, 1, rnd.setup_width), device=dev)
            one_p = rnd.kernel_params(scene)
            raw["pack_setups_one"] = lambda rnd=rnd, one_p=one_p, one=one, t=one_table: (
                rnd.launch_pack(one_p, one, t))
            work["pack_setups"] = (
                None, lambda rnd=rnd, pos=pos: raycast.pack_setups(scene, rnd.cam_meta, pos),
                reps * e * (16 + rnd.setup_width) * 4, None)
    for mix, (_, ops_per, _) in roofline.CHAINS.items():
        x = roofline.initial(mix, roofline.SHAPE, dev)
        out = torch.empty_like(x)
        work[f"roofline_{mix}"] = (
            lambda mix=mix, x=x: roofline.run_chain(mix, x, K6_ROW_ITERS),
            lambda mix=mix, x=x: roofline.plain_chain(mix, x, K6_ROW_ITERS),
            2 * x.numel() * x.element_size(), ops_per * x.numel() * K6_ROW_ITERS)
        raw[f"roofline_{mix}"] = lambda mix=mix, x=x, out=out: roofline.launch(
            mix, x, out, K6_ROW_ITERS)
    total_launches = {name: sum(p.get(name, 0) for p in launches_by_path.values())
                      for name, _, _ in KERNELS}
    frames_te = torch.empty((e, reps, renderer.frame_width), dtype=torch.uint8, device=dev)
    render_p, poses_te = renderer.kernel_params(scene), poses_te.contiguous()
    k3_training_end_ms = time_ms(lambda: renderer.launch(render_p, poses_te, frames_te), reps=50)
    usage = ptxas_usage(info["log"])
    rows = []
    with torch.no_grad():
        for name, source, replaces in KERNELS:
            wrapper_fn, plain_fn, nbytes, ops = work[name]
            ops = census(plain_fn) if ops is None else ops
            peak_ops = peak.get(name.removeprefix("roofline_"), PEAK_F32_OPS_PER_S)
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": total_launches[name],
                "launches_by_path": {p: v.get(name, 0) for p, v in launches_by_path.items()},
                "max_abs_err": errs[name],
                "seeded_max_abs_err": seeded_errs.get(name),
                "ms": time_ms(raw[name], reps=50),
                "device_ms": kernel_device_ms(raw[name]),
                "wrapper_ms": None if wrapper_fn is None else time_ms(wrapper_fn, reps=50),
                "plain_ms": time_ms(plain_fn, reps=3, warmup=1),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "census_ops": ops, "bytes": nbytes,
                **usage_of(usage, name),
            })
            if name in full_ops:
                rows[-1]["bound_ms_full_work"] = max(
                    t_bytes, full_ops[name] / PEAK_F32_OPS_PER_S * 1e3)
                rows[-1]["census_ops_full_work"] = full_ops[name]
                rows[-1]["skipped_cast_share"] = skipped_main[name.removeprefix(
                    "render_repeats").removeprefix("render_batched")]
            if name == "render_repeats":
                rows[-1]["ms_training_end"] = k3_training_end_ms
                rows[-1]["skipped_cast_share_training_end"] = (
                    cull["training_end"]["k3"]["skipped_cast_share"])
            if name in other_errs:
                rows[-1]["other_max_abs_err"] = other_errs[name]
            if name in ld_ms:
                rows[-1]["ms_lowdim_8192_envs"] = ld_ms[name]
            if name == "pack_setups":
                # The floor of a launch: the same kernel on one (repeat, env).
                rows[-1]["floor_ms"] = time_ms(raw["pack_setups_one"], reps=50)
                rows[-1]["floor_device_ms"] = kernel_device_ms(raw["pack_setups_one"])
    # Where a main-path step goes: the actor's forward at full width beside
    # the kernels' times and the measured wall time of a sim-only step.
    actor_ms = time_ms(lambda: act(obs0), reps=20)
    step_ms = 1e3 * NUM_ENVS / sim_rate
    emit("kernels_timed", card=smi, actor_forward_ms=actor_ms, sim_only_step_ms=step_ms)

    # 9. device time from torch.profiler traces: a few sim-only steps (the
    # card's busy share and the kernels that take it), then one training
    # segment per row split into the port's kernels, the learner and the
    # rest.  Null where a trace holds no device time.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_STEPS):
            obs_in = resolve_obs(done, pool[1], obs)
            states, obs, reward, done = venv.step_lazy(states, act(obs_in), reset_pool=pool)
        torch.cuda.synchronize()
    device_ms = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            device_ms[ev.key[:80]] = us / 1e3 / PROFILE_STEPS
    device_step_ms = sum(device_ms.values()) or None
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    training = {name: training_profile(t["state"], t["segment"], t["step_ms"])
                for name, t in trained.items()}
    emit("profile", steps=PROFILE_STEPS, device_ms_per_step=device_step_ms,
         device_busy_share=device_step_ms and device_step_ms / step_ms,
         device_kernels=len(device_ms), top_device_ms_per_step=dict(top),
         training=training)

    # 10. the port's bench: bench_torch.py's suite in a child process, the
    # four rows of the JAX bench, each in a child of its own.
    argv = [sys.executable, "bench_torch.py", "--row-timeout", str(BENCH_ROW_TIMEOUT_S),
            "--row-attempts", "1"]
    budget = WATCHDOG_S - (time.monotonic() - t0) - BENCH_MARGIN_S
    rc, out, err = run_group(argv, budget, os.path.dirname(os.path.abspath(__file__)))
    bench_rows, summary, bench_checks = bench_check(out)
    bench_checks["exit_0"] = rc == 0
    emit("bench", argv=argv[1:], rc=rc, rows=bench_rows,
         summary={k: v for k, v in summary.items() if k != "rows"}, checks=bench_checks)
    if not all(bench_checks.values()):
        raise AssertionError(f"bench checks failed: {bench_checks}\n{err[-4000:]}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

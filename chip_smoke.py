#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cartpoleplusplus_tpu_torch/csrc`` with plain
nvcc, holds each kernel against its plain PyTorch version on the card, then
drives the port's main path at config 5 (2 cameras, 50×50 renders,
obs_pool 2, obs_samples 2, 3 repeats × 5 substeps, 4096 envs): a greedy
DDPG actor with seeded random weights runs full evaluation rollouts, then
windows of lazily auto-resetting steps, each over a second.  Each kernel
is held against its plain version again on the main path's own inputs and
timed there; a torch.profiler trace of a few more steps gives the card's
busy share.  Each phase prints one JSON line with the elapsed seconds; the
line before the last two holds every kernel's launches, error, time and
bound; the last line is ``{"ok": true, "device": {...}}``.

A watchdog turns a hang into a traceback and a nonzero exit after 300 s.
Without CUDA, or without the port beside it, the script fails before
printing any result.
"""

from __future__ import annotations

import faulthandler
import json
import math
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.agents.common import eval_rollout, make_venv
from cartpoleplusplus_tpu_torch.agents.ddpg import greedy_act
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.env.vector import resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import Actor
from cartpoleplusplus_tpu_torch.physics import cuda_step, soa
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.render import raycast
from cartpoleplusplus_tpu_torch.render.cuda_render import SlabRenderer

WATCHDOG_S = 300
SEED = 0
NUM_ENVS = 4096
PARITY_ENVS = 1024
SIM_ONLY_WINDOWS = 3
EVAL_ROLLOUTS = 3
SIM_ONLY_STEPS = 700  # per window: over a second at 1.6-1.9 ms per step
PROFILE_STEPS = 20
# Published H100 SXM peaks: HBM bandwidth and float32 (non-tensor-core) rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Tolerances: physics atol, pixel levels (|Δ| ≤ 2 on ≥ 99.9%, mean < 0.5).
PHYS_ATOL = 1e-5
PIX_LEVEL, PIX_SHARE, PIX_MEAN = 2, 0.999, 0.5

CONFIG5 = CartpoleConfig(
    discrete_actions=False, use_raw_pixels=True, num_cameras=2, render_width=50,
    render_height=50, obs_pool=2, obs_samples=2, action_repeats=3, steps_per_repeat=5,
    solver_iterations=3,
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


def raw_launches(scene, renderer, rigid, force, poses, spr, n_push):
    """Closures that launch each kernel on prepared buffers through the
    package's launch functions, so that timing sees the kernels and not the
    wrappers' packing.  They count no launches."""
    e, reps = rigid.pos.shape[0], poses.shape[0]
    packed, force_t = soa.pack_state(rigid).contiguous(), force.t().contiguous()
    state_out, pose_out = torch.empty_like(packed), torch.empty_like(poses)
    poses_r = poses.contiguous()
    poses_b = raycast.poses_from_rigid(rigid)[None].contiguous()
    frames_r = torch.empty((e, reps, renderer.frame_width), dtype=torch.uint8, device=poses.device)
    frames_b = torch.empty((e, 1, renderer.frame_width), dtype=torch.uint8, device=poses.device)
    phys_p, render_p = cuda_step.phys_params(scene), renderer.kernel_params(scene)
    return {
        "step_repeats": lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, pose_out, reps, spr),
        "step_substeps": lambda: cuda_step.launch(
            phys_p, packed, force_t, state_out, None, 1, n_push),
        "render_repeats": lambda: renderer.launch(render_p, poses_r, frames_r),
        "render_batched": lambda: renderer.launch(render_p, poses_b, frames_b),
    }


def parity(scene, renderer, rigid, force) -> tuple[dict, dict]:
    """Each kernel against its plain version on these inputs → (max abs
    error by kernel, pixel statistics by render kernel); raises where one
    disagrees.  K3 renders the poses of the plain K1.

    The physics kernels are held against the plain version on the CPU:
    PyTorch's CUDA rsqrt is approximate, which on its own moves the pole's
    spin ~1e-4 off the exactly rounded result after 30 substeps."""
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


def parity_inputs(scene, device):
    """E states from a seed: the reset push then a few random steps (plain
    PyTorch), so contacts and tilts vary; plus a force for the next step."""
    g = torch.Generator(device=device).manual_seed(SEED)
    e = PARITY_ENVS
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


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        return run()
    finally:
        faulthandler.cancel_dump_traceback_later()


def run() -> int:
    t0 = time.monotonic()

    def emit(phase: str, **fields):
        print(json.dumps({"phase": phase, "elapsed_s": round(time.monotonic() - t0, 3),
                          **fields}), flush=True)

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
    renderer = SlabRenderer(CONFIG5, dev)
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

    # 4. main path at full width
    venv = make_venv(CONFIG5, NUM_ENVS)
    actor = Actor(CONFIG5.obs_shape, use_raw_pixels=True, height=CONFIG5.obs_height,
                  width=CONFIG5.obs_width, generator=torch.Generator().manual_seed(SEED))
    act = greedy_act(actor)
    gen = torch.Generator(device=dev).manual_seed(SEED)
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
        "launches_all_positive": all(v > 0 for v in launches.values()),
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

    # 5. kernels at the main path's shapes: parity, time, plain time, bound
    e, reps = NUM_ENVS, CONFIG5.action_repeats
    spr, n_push = CONFIG5.steps_per_repeat, CONFIG5.initial_force_steps
    state0, obs0 = venv.reset(gen)
    rigid0 = state0.rigid
    with torch.no_grad():
        force0 = cartpole.action_to_force(CONFIG5, act(obs0))
    errs, pix = parity(scene, renderer, rigid0, force0)
    emit("parity_main_path", envs=NUM_ENVS, physics_atol=PHYS_ATOL,
         step_substeps_max_abs_err=errs["step_substeps"],
         step_repeats_max_abs_err=errs["step_repeats"], **pix)
    _, poses0 = cuda_step.step_repeats(scene, rigid0, force0, spr, reps)
    frame_bytes = CONFIG5.pixel_obs_shape[1]
    ray_bytes = renderer.planes.numel() * 4
    work = {
        "step_repeats": (
            lambda: cuda_step.step_repeats(scene, rigid0, force0, spr, reps),
            lambda: soa.step_repeats_batched(scene, rigid0, force0, spr, reps),
            (26 + 3 + 26 + reps * 16) * 4 * e),
        "step_substeps": (
            lambda: cuda_step.step_substeps(scene, rigid0, force0, n_push),
            lambda: soa.step_substeps_batched(scene, rigid0, force0, n_push),
            (26 + 3 + 26) * 4 * e),
        "render_repeats": (
            lambda: renderer.render_repeats(scene, poses0),
            lambda: renderer.plain(scene, poses0),
            reps * e * 16 * 4 + ray_bytes + e * reps * frame_bytes),
        "render_batched": (
            lambda: renderer.render_batched(scene, rigid0),
            lambda: renderer.plain(scene, raycast.poses_from_rigid(rigid0)[None]),
            e * 16 * 4 + ray_bytes + e * frame_bytes),
    }
    raw = raw_launches(scene, renderer, rigid0, force0, poses0, spr, n_push)
    rows = []
    with torch.no_grad():
        for name, source, replaces in KERNELS:
            wrapper_fn, plain_fn, nbytes = work[name]
            ops = census(plain_fn)
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
            rows.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": errs[name],
                "seeded_max_abs_err": seeded_errs[name],
                "ms": time_ms(raw[name], reps=50),
                "wrapper_ms": time_ms(wrapper_fn, reps=50),
                "plain_ms": time_ms(plain_fn, reps=3, warmup=1),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
                "census_ops": ops, "bytes": nbytes,
            })
    # Where a main-path step goes: the actor's forward at full width beside
    # the kernels' times and the measured wall time of a sim-only step.
    actor_ms = time_ms(lambda: act(obs0), reps=20)
    step_ms = 1e3 * NUM_ENVS / sim_rate
    emit("kernels_timed", card=smi, actor_forward_ms=actor_ms, sim_only_step_ms=step_ms)

    # 6. device time of sim-only steps, from a torch.profiler trace: the
    # card's busy share of a step (against the unprofiled step time) and
    # the device kernels that take it.  Null where the trace holds no
    # device time.
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
    emit("profile", steps=PROFILE_STEPS, device_ms_per_step=device_step_ms,
         device_busy_share=device_step_ms and device_step_ms / step_ms,
         device_kernels=len(device_ms), top_device_ms_per_step=dict(top))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's benchmark: port of cartpoleplusplus_tpu.utils.benchmark.

Measures the training loop of the port (sim + render + act + learn, the
kernels of ``csrc/`` on one card) in env steps/s, or with ``--sim-only``
the env alone under a fixed policy, and prints machine-readable JSON lines
(the repo-root ``bench_torch.py`` wraps this).  Each row is timed in
best-of-N windows of whole segments, each extended until it spans
``--min-wall-s``; every window is recorded.

Every row also carries a ceiling: the card's float32 element-op rate on the
render-like op mix, measured in the row's own process by the op-rate probe
(K6, ``utils/roofline.py``), over the config's census of operations per env
step (the algorithm's op counts, those of the JAX package).

The default suite runs the four rows of the JAX bench (``ROW_SPECS``), each
in a watchdogged child process, one JSON line per row as it lands, then a
summary line.  Nothing falls back: a row whose build, kernel or warm-up
fails is dropped with its error on stderr and the summary carries
``error``; without a card the bench prints one ``{"error": ...}`` line and
exits non-zero, without running anything on the CPU.  ``--device cpu``
runs the plain PyTorch versions on the CPU (for tests; such rows carry no
device numbers and are never recorded).

Usage:
  python -m cartpoleplusplus_tpu_torch.utils.benchmark [--num-envs 4096] [...]
  python3 bench_torch.py --single --lowdim --trace-dir /tmp/trace
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from cartpoleplusplus_tpu_torch import kernels, resolve_device
from cartpoleplusplus_tpu_torch.utils import roofline

BASELINE_TARGET = 1e7  # env steps/s, BASELINE.json's stated target

# Operation counts of the algorithm, as the JAX package counts them (its
# element-weighted census of each cast, per shaded ray, and of one physics
# substep): properties of the algorithm, not measurements.
RENDER_OPS_PER_RAY = {
    "raster_mxu": 62.4,   # projective raster, bound planes as one product
    "raster": 110.4,      # projective inverse-depth raster
    "slab_recip": 162.3,  # affine slab cascade + approximate reciprocal
    "slab_ratio": 188.3,  # division-free cross-multiplied ratio cascade
}
# One substep: 2160 fixed (manifold, integration, corners) + 924 per Jacobi
# solver iteration.
PHYS_OPS_FIXED = 2160
PHYS_OPS_PER_ITER = 924
# The op-rate probe's chain whose rate bounds these loops (compares,
# selects, multiplies and adds, as the casts are made of).
MIX_CHAIN = "mix_f32"


def census_ops_per_step(opts) -> float:
    """Census operations per env step: physics over every substep, plus
    for pixel rows the cast of every ray.  Rays per step = cameras ×
    repeats × pooled pixels × samples per pooled pixel (``obs_samples`` 0
    means all ``obs_pool``² sub-pixels).  The actor, critic and replay are
    not counted."""
    repeats = getattr(opts, "action_repeats", 3)
    substeps = repeats * getattr(opts, "steps_per_repeat", 5)
    phys = PHYS_OPS_FIXED + getattr(opts, "solver_iters", 3) * PHYS_OPS_PER_ITER
    ops = phys * substeps
    if not getattr(opts, "lowdim", False):
        pool = max(1, getattr(opts, "obs_pool", 2))
        samples = getattr(opts, "obs_samples", 0) or pool * pool
        rays = (getattr(opts, "num_cameras", 1) * repeats
                * (50 // pool) * (50 // pool) * samples)
        if getattr(opts, "render_raster", False):
            kernel = "raster_mxu" if getattr(opts, "render_mxu", False) else "raster"
        else:
            kernel = "slab_recip" if getattr(opts, "render_recip", True) else "slab_ratio"
        ops += RENDER_OPS_PER_RAY[kernel] * rays
    return ops


def census_ceiling(opts, ops_per_s: float) -> float:
    """Throughput bound (env steps/s) at ``ops_per_s`` element ops per
    second: ``ops_per_s / census_ops_per_step(opts)``."""
    return ops_per_s / census_ops_per_step(opts)


DEFAULT_NUM_ENVS = 4096


def add_bench_opts(parser: argparse.ArgumentParser) -> None:
    """The JAX bench's flags, defaults and meaning, less those that choose
    between TPU backends and tile sizes (``--pallas-render``,
    ``--pallas-physics``, ``--no-fused-step``, ``--render-tile-e``: the port
    has one path), plus ``--device``."""
    parser.add_argument("--num-envs", type=int, default=DEFAULT_NUM_ENVS)
    parser.add_argument("--num-cameras", type=int, default=1)
    parser.add_argument("--action-repeats", type=int, default=3)
    parser.add_argument("--steps-per-repeat", type=int, default=5)
    parser.add_argument("--steps-per-segment", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--replay-capacity", type=int, default=8192,
                        help="must exceed --num-envs for the s2-free replay "
                             "(replay/buffer.py) to engage")
    parser.add_argument("--segments", type=int, default=5)
    parser.add_argument("--lowdim", action="store_true",
                        help="benchmark low-dim obs instead of pixels")
    parser.add_argument("--sim-only", action="store_true",
                        help="benchmark sim+render only (no learner)")
    parser.add_argument("--obs-pool", type=int, default=2,
                        help="k×k average-pool in the render epilogue "
                             "(env/config.py obs_pool)")
    parser.add_argument("--render-recip", action="store_true", default=True,
                        help="slab casts with the approximate reciprocal "
                             "(K3/K4; the default)")
    parser.add_argument("--no-render-recip", dest="render_recip", action="store_false",
                        help="slab casts with the division-free ratio cascade (K5b)")
    parser.add_argument("--render-raster", action="store_true", default=None,
                        help="cast with the projective raster (K5a) instead of a "
                             "slab cascade.  Default: per config "
                             "(render.prefer_raster: exact configs raster, "
                             "sampled ones slab)")
    parser.add_argument("--no-render-raster", dest="render_raster", action="store_false")
    parser.add_argument("--render-mxu", action="store_true", default=False,
                        help="with the raster, compute the bound planes as one "
                             "tensor-core product (K5d)")
    parser.add_argument("--obs-samples", type=int, default=0,
                        help="sub-pixel samples per pooled obs pixel "
                             "(0 = all obs-pool² = exact)")
    parser.add_argument("--pixel-pool", type=int, default=1,
                        help="encoder-side pool of the networks' pixel input")
    parser.add_argument("--solver-iters", type=int, default=3,
                        help="Jacobi contact-solver iterations per substep")
    parser.add_argument("--raster-hoist", dest="raster_hoist", action="store_true",
                        default=False,
                        help="with the raster, pack the per-env setup in a pass "
                             "of its own first (K5c)")
    parser.add_argument("--no-raster-hoist", dest="raster_hoist", action="store_false",
                        help="explicit off (the default)")
    parser.add_argument("--trace-dir", type=str, default=None,
                        help="write a torch.profiler trace of the timed windows "
                             "here; the row then carries _device_busy_share, "
                             "and its rate is a traced rate")
    parser.add_argument("--min-wall-s", type=float, default=0.5,
                        help="extend each timed window (doubling its segments) "
                             "until it spans at least this much wall time")
    parser.add_argument("--bench-windows", type=int, default=3,
                        help="timed windows per row; the best is reported, every "
                             "one is recorded in _windows")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu, which runs the plain "
                             "PyTorch versions and reports no device numbers")


def bench_config(opts):
    """The env config of a row, as the JAX bench builds it."""
    from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig

    return CartpoleConfig(
        discrete_actions=False,
        use_raw_pixels=not opts.lowdim,
        num_cameras=opts.num_cameras,
        render_width=50,
        render_height=50,
        action_repeats=opts.action_repeats,
        steps_per_repeat=opts.steps_per_repeat,
        obs_pool=getattr(opts, "obs_pool", 1) if not opts.lowdim else 1,
        obs_samples=getattr(opts, "obs_samples", 0) if not opts.lowdim else 0,
        solver_iterations=getattr(opts, "solver_iters", 3),
    )


def build(opts):
    """(state, segment) for the configured loop; ``segment(state) ->
    (state, metrics)`` runs ``steps_per_segment`` env steps and returns
    device scalars.  Resolves ``opts.render_raster`` when it is None."""
    from cartpoleplusplus_tpu_torch.agents import ddpg
    from cartpoleplusplus_tpu_torch.agents.common import make_venv
    from cartpoleplusplus_tpu_torch.env.vector import resolve_obs
    from cartpoleplusplus_tpu_torch.render import prefer_raster

    dev = resolve_device(getattr(opts, "device", None))
    config = bench_config(opts)
    if getattr(opts, "render_raster", None) is None:
        # Resolved on opts, so the ceiling and _render_raster see the kernel
        # built here.
        opts.render_raster = (not opts.lowdim) and prefer_raster(
            config.num_cameras, config.obs_pool, config.obs_samples)
    render = {} if opts.lowdim else dict(
        render_raster=opts.render_raster,
        render_recip=getattr(opts, "render_recip", True),
        render_mxu=getattr(opts, "render_mxu", False),
        render_hoist=getattr(opts, "raster_hoist", False),
    )
    venv = make_venv(config, opts.num_envs, device=dev, **render)
    e, steps = opts.num_envs, opts.steps_per_segment

    if opts.sim_only:
        states, obs = venv.reset(torch.Generator(device=dev).manual_seed(0))

        @torch.no_grad()
        def sim_segment(carry):
            states, obs, prev_done = carry
            reward = torch.zeros((), device=dev)
            for _ in range(steps):
                obs_in = resolve_obs(prev_done, obs, obs)
                action = torch.tanh(obs_in.reshape(e, -1)[:, :2].float())
                states, obs, r, prev_done = venv.step_lazy(states, action,
                                                           reset_pool=(states, obs))
                reward = reward + r.mean()
            return (states, obs, prev_done), {"reward": reward / steps}

        return (states, obs, torch.zeros((e,), dtype=torch.bool, device=dev)), sim_segment

    st = ddpg.init_state(SimpleNamespace(seed=0, replay_capacity=opts.replay_capacity),
                         config, venv, actor_lr=1e-4, critic_lr=1e-3,
                         pixel_pool=getattr(opts, "pixel_pool", 1))
    train_segment = ddpg.make_segment(
        venv, gamma=0.99, tau=0.005, batch_size=opts.batch_size, warmup_steps=0,
        steps_per_segment=steps, ou_theta=0.15, ou_sigma=0.2,
    )
    return st, lambda st: (st, train_segment(st))


# Name fragments of the port's own kernels (csrc/), as a profiler names them.
PORT_KERNELS = ("phys_kernel", "render_slab_kernel", "render_raster_kernel",
                "render_raster_mxu_kernel", "pack_setups_kernel")


def device_events(prof) -> list:
    """The device-side kernel and copy events of a torch.profiler trace
    (not the spans that record_function and the optimizer draw on the
    device timeline)."""
    return [e for e in prof.events()
            if str(e.device_type).endswith("CUDA") and not getattr(e, "is_user_annotation", False)]


def card_power_limit() -> str:
    """The first card's power limit as ``nvidia-smi`` reports it (e.g.
    ``700.00 W``)."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return line.rsplit(",", 1)[1].strip()


def timed_windows(segment, st, opts, seen: list | None = None):
    """``opts.bench_windows`` timed windows, after the caller's warm
    segment: each of whole segments, doubling until it spans
    ``opts.min_wall_s`` (capped at 64 × ``opts.segments``), each starting
    at the size the previous one reached, synced by reading one device
    scalar → (state, [(segments, seconds)]).  ``seen``, a list, gets every
    segment's metrics."""
    min_wall = getattr(opts, "min_wall_s", 0.5)

    def window(first_batch: int):
        nonlocal st
        segs, batch = 0, first_batch
        t0 = time.perf_counter()
        while True:
            for _ in range(batch):
                st, m = segment(st)
                if seen is not None:
                    seen.append(m)
            float(m["reward"])
            dt = time.perf_counter() - t0
            segs += batch
            if dt >= min_wall or segs >= opts.segments * 64:
                return segs, dt
            batch = segs  # double the window

    windows = [window(opts.segments)]
    for _ in range(max(1, getattr(opts, "bench_windows", 3)) - 1):
        windows.append(window(windows[-1][0]))
    return st, windows


def best_window(windows, env_steps_per_segment: int):
    """(env steps/s of the fastest window, its (segments, seconds), every
    window's rate)."""
    rates = [round(s * env_steps_per_segment / t, 1) for s, t in windows]
    best = max(windows, key=lambda w: w[0] / w[1])
    return best[0] * env_steps_per_segment / best[1], best, rates


def run(opts) -> dict:
    """One row: build, one warm segment, ``bench_windows`` timed windows
    (:func:`timed_windows`), then the card's mix rate → the row's JSON
    dict, the best window's rate as ``value``."""
    dev = resolve_device(getattr(opts, "device", None))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    st, segment = build(opts)
    st, m = segment(st)
    float(m["reward"])  # sync: read one device scalar

    prof = None
    if opts.trace_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    try:
        st, windows = timed_windows(segment, st, opts)
    finally:
        if prof is not None:
            prof.stop()

    per_step = opts.steps_per_segment * opts.num_envs
    sps, (segs_run, dt), window_sps = best_window(windows, per_step)
    env_steps = segs_run * per_step
    name = "batched_env_steps_per_sec_per_chip"
    if not opts.lowdim:
        name += "_pixel_render"
    if opts.sim_only:
        name += "_sim_only"
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20 if cuda else None
    mix = roofline.measure_chain(MIX_CHAIN, device=dev)["el_ops_per_s"] if cuda else None
    ceiling = census_ceiling(opts, mix) if mix else None
    row = {
        "metric": name,
        "value": round(sps, 1),
        "unit": "env_steps/sec/chip",
        "vs_baseline": round(sps / BASELINE_TARGET, 4),
        "ceiling": None if ceiling is None else round(ceiling, 1),
        "vs_ceiling": None if ceiling is None else round(sps / ceiling, 4),
        "_wall_s": round(dt, 3),
        "_windows": window_sps,
        "_env_steps": env_steps,
        "_num_envs": opts.num_envs,
        "_num_cameras": None if opts.lowdim else getattr(opts, "num_cameras", None),
        "_obs_samples": None if opts.lowdim else getattr(opts, "obs_samples", None),
        "_backend": dev.type,
        "_device": torch.cuda.get_device_name(dev) if cuda else None,
        "_power_limit": card_power_limit() if cuda else None,
        "_peak_mem_mib": peak_mib,
        "_mix_ops_per_s": mix,
        "_census_ops_per_step": census_ops_per_step(opts),
        "_render_raster": bool(getattr(opts, "render_raster", False)) and not opts.lowdim,
    }
    if prof is not None:
        os.makedirs(opts.trace_dir, exist_ok=True)
        path = os.path.join(opts.trace_dir, f"bench_trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        events = device_events(prof) if cuda else []
        busy_us = sum(e.time_range.elapsed_us() for e in events)
        ours_us = sum(e.time_range.elapsed_us() for e in events
                      if any(k in e.name for k in PORT_KERNELS))
        wall = sum(t for _, t in windows)
        steps = sum(s for s, _ in windows) * opts.steps_per_segment
        # A traced rate: the profiler's own host cost is in these windows, so
        # the busy share is that of the traced run; the device times per env
        # step are not inflated by it.
        row.update(_traced=True, _trace=path,
                   _device_busy_share=busy_us / 1e6 / wall if busy_us else None,
                   _device_ms_per_step=busy_us / 1e3 / steps if busy_us else None,
                   _kernels_ms_per_step=ours_us / 1e3 / steps if busy_us else None)
    return row


_PROBE_CODE = (
    "import torch; assert torch.cuda.is_available(); "
    "x = torch.ones((8, 8), device='cuda'); assert float((x @ x).sum()) == 512.0"
)


def probe_backend(timeout_s: float = 150) -> bool:
    """Is the card there: one small product on ``cuda`` in a child
    process, killed after ``timeout_s``."""
    try:
        return subprocess.run([sys.executable, "-c", _PROBE_CODE], timeout=timeout_s,
                              capture_output=True).returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


# The JAX bench's suite: config 5 first (the headline), then the 1-camera
# exact row, the one-sample ray-count row and the low-dim row.
ROW_SPECS = [
    ("2cam_samples2 (BASELINE config 5, production)", "_2cam_s2",
     {"num_cameras": 2, "obs_samples": 2}),
    ("1cam_exact (r1/r2 headline)", "_1cam_exact",
     {"num_cameras": 1, "obs_samples": 0}),
    ("1cam_samples1 (ray-count speed config)", "_1cam_s1",
     {"num_cameras": 1, "obs_samples": 1}),
    # The low-dim row runs at 8192 envs, as in the JAX suite; an explicit
    # --num-envs from the user wins (see main).
    ("lowdim (sim+learn, no renderer, 8192 envs)", "_lowdim",
     {"lowdim": True, "num_envs": 8192}),
]

NORTH_STAR_NOTE = (
    "vs_baseline = value / 1e7, the target BASELINE.json states (a target, "
    "not a measurement); vs_ceiling = value / ceiling, where ceiling = this "
    "card's float32 mix rate measured in the row's process by the op-rate "
    "probe (K6, _mix_ops_per_s) / the config's census ops per env step "
    "(_census_ops_per_step)"
)


def _child_argv(opts, overrides: dict) -> list:
    """argv for a ``--single`` child row: base opts + per-row overrides."""
    merged = dict(
        num_envs=opts.num_envs, num_cameras=opts.num_cameras,
        action_repeats=opts.action_repeats, steps_per_repeat=opts.steps_per_repeat,
        steps_per_segment=opts.steps_per_segment, batch_size=opts.batch_size,
        replay_capacity=opts.replay_capacity, segments=opts.segments,
        obs_pool=opts.obs_pool, obs_samples=opts.obs_samples, pixel_pool=opts.pixel_pool,
        solver_iters=opts.solver_iters, min_wall_s=opts.min_wall_s,
        bench_windows=opts.bench_windows, device=opts.device,
    )
    flags = dict(
        lowdim=opts.lowdim, sim_only=opts.sim_only, render_recip=opts.render_recip,
        render_raster=opts.render_raster, render_mxu=opts.render_mxu,
        raster_hoist=opts.raster_hoist,
    )
    for k, v in overrides.items():
        (flags if isinstance(v, bool) else merged)[k] = v
    # --probe-timeout 0: the parent probes; the row watchdog bounds a child.
    argv = [sys.executable, "-m", "cartpoleplusplus_tpu_torch.utils.benchmark",
            "--single", "--probe-timeout", "0"]
    for k, v in merged.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    for k, v in flags.items():
        name = k.replace("_", "-")
        if v is True:
            argv.append(f"--{name}")
        elif v is False and k in ("render_recip", "render_raster"):
            argv.append(f"--no-{name}")
        # None (tristate auto) and False store_true flags: omitted.
    if opts.trace_dir:
        argv += ["--trace-dir", opts.trace_dir]
    return argv


def _parse_last_json(text):
    for line in reversed((text or "").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                pass
    return None


def _child_env():
    """The child's environment, with the port's parent directory first on
    PYTHONPATH: the ``-m`` child must import the same package as a parent
    started as ``python /path/to/bench_torch.py`` from any directory."""
    import cartpoleplusplus_tpu_torch

    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(
        cartpoleplusplus_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_parent] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _run_row_subprocess(argv, timeout_s):
    """One row attempt in a watchdogged child → its JSON dict, or None.
    The child's stderr is forwarded.  A child killed at the watchdog after
    it printed its result (hung in teardown) is salvaged."""
    try:
        proc = subprocess.run(argv, timeout=timeout_s, capture_output=True, text=True,
                              env=_child_env())
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout
        salvaged = _parse_last_json(out)
        if salvaged is not None and "value" in salvaged:
            print(f"# row child hung after printing its result "
                  f"(killed at {timeout_s:.0f}s); salvaged", file=sys.stderr)
            return salvaged
        print(f"# row attempt timed out after {timeout_s:.0f}s (killed)", file=sys.stderr)
        return None
    if proc.stderr:
        sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        print(f"# row attempt failed rc={proc.returncode}", file=sys.stderr)
        return None
    result = _parse_last_json(proc.stdout)
    if result is None:
        print("# row attempt printed no JSON line", file=sys.stderr)
    return result


def _emit(obj) -> None:
    """One JSON line, flushed at once: a kill of this process loses no row
    that already completed."""
    print(json.dumps(obj), flush=True)


# Every successful measurement on the card is kept here; a failure's error
# line carries the latest as ``last_measured``.  The port's own file: the
# JAX bench's runs/bench_last_measured.json is never read or written.
LAST_MEASURED = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "runs",
    "bench_torch_last_measured.json"))


def _iso_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def record_last_measured(summary: dict, path: str | None = None) -> None:
    """Persist a successful measurement (suite summary or single row) to
    ``path`` (default :data:`LAST_MEASURED`), only where every row ran on
    ``cuda`` and names its card and power limit.  Keyed ``suite`` or per
    config; ``value`` is the latest, ``best`` the largest seen, and a
    latest under half the best is flagged ``degraded_vs_best``.  An
    unwritable tree never fails the measurement."""
    if not summary.get("value"):
        return
    metas = [r.get("meta") or {} for r in summary.get("rows") or []] or [summary]
    if not all(m.get("_backend") == "cuda" and m.get("_device") and m.get("_power_limit")
               for m in metas):
        return
    entry = {
        "recorded_by": "bench_torch",
        "timestamp_iso": _iso_now(),
        "metric": summary.get("metric"),
        "value": summary.get("value"),
        "unit": summary.get("unit"),
        "vs_baseline": summary.get("vs_baseline"),
        "device": metas[0]["_device"],
        "power_limit": metas[0]["_power_limit"],
        "config": {k: summary.get(k) for k in ("_num_envs", "_num_cameras", "_obs_samples")
                   if summary.get(k) is not None},
        "rows": summary.get("rows"),
    }
    path = path or LAST_MEASURED
    try:
        prior = {}
        if os.path.exists(path):
            with open(path) as f:
                prior = json.load(f)
        if summary.get("rows"):
            key = "suite"
        else:
            key = str(summary.get("metric")) + "".join(
                f"|{k[1:]}={summary[k]}" for k in ("_num_cameras", "_obs_samples", "_num_envs")
                if summary.get(k) is not None)
        old = prior.get(key) or {}
        best = old.get("best")
        if not best or entry["value"] >= best["value"]:
            best = {"value": entry["value"], "timestamp_iso": entry["timestamp_iso"]}
        entry["best"] = best
        if entry["value"] < 0.5 * best["value"]:
            entry["degraded_vs_best"] = round(entry["value"] / best["value"], 4)
        prior[key] = entry
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(prior, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except (OSError, ValueError) as e:
        print(f"# last_measured not persisted: {e}", file=sys.stderr)


def load_last_measured(path: str | None = None):
    """The recorded measurements, or None if there are none."""
    try:
        with open(path or LAST_MEASURED) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="cartpole++ PyTorch/CUDA benchmark")
    add_bench_opts(parser)
    parser.add_argument(
        "--single", action="store_true",
        help="benchmark exactly the flags given (one row, in-process).  Default: "
             "the suite of ROW_SPECS, each row in a watchdogged child process")
    parser.add_argument(
        "--probe-timeout", type=float, default=150,
        help="seconds for the card probe, run in a killable child before "
             "anything is built and after a failed row (0 skips it)")
    parser.add_argument("--row-timeout", type=float, default=1500,
                        help="per-attempt watchdog for one suite row (seconds)")
    parser.add_argument("--row-attempts", type=int, default=2,
                        help="attempts per suite row before dropping it")
    return parser


def main(argv=None) -> int:
    opts = make_parser().parse_args(argv)
    cuda = torch.device(opts.device).type == "cuda"

    def emit_error(error: str) -> int:
        _emit({
            "metric": "batched_env_steps_per_sec_per_chip_pixel_render",
            "value": 0.0, "unit": "env_steps/sec/chip", "vs_baseline": 0.0,
            "error": error, "last_measured": load_last_measured(),
            "north_star": NORTH_STAR_NOTE,
        })
        return 1

    if cuda and not torch.cuda.is_available():
        return emit_error("card unavailable: torch.cuda.is_available() is False")
    if cuda and opts.probe_timeout > 0 and not probe_backend(opts.probe_timeout):
        return emit_error(f"card unavailable: the {opts.probe_timeout:g}s probe failed "
                          "before any build")

    if opts.single or opts.lowdim:
        result = run(opts)
        _emit(result)
        record_last_measured(result)
        return 0

    if cuda:
        # Built once here, so no row's watchdog pays for nvcc.
        try:
            kernels.build()
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            return emit_error(f"kernel build failed: {e}")

    done, dropped, aborted = [], [], None  # done: (result, label, tag)
    for label, tag, overrides in ROW_SPECS:
        row_over = dict(overrides)
        # A row's num_envs is its default shape; a --num-envs other than the
        # default wins.
        if "num_envs" in row_over and opts.num_envs != DEFAULT_NUM_ENVS:
            row_over["num_envs"] = opts.num_envs
        result = None
        for attempt in range(1, max(1, opts.row_attempts) + 1):
            result = _run_row_subprocess(_child_argv(opts, row_over), opts.row_timeout)
            if result is not None:
                # A row that needed a second attempt says so in its line and
                # in the summary's meta.
                result["_attempts"] = attempt
                break
            if cuda and opts.probe_timeout > 0 and not probe_backend(opts.probe_timeout):
                aborted = "card lost mid-suite"
                break
        if result is not None:
            _emit({"config": label, **result})
            done.append((result, label, tag))
        else:
            print(f"# row dropped: {label}", file=sys.stderr)
            dropped.append(label)
        if aborted:
            break

    if not done:
        return emit_error(aborted or "all bench rows failed (see stderr)")
    head, _, head_tag = done[0]  # config 5; else the first row that ran
    out = {
        "metric": head["metric"] + head_tag,
        "value": head["value"],
        "unit": head["unit"],
        "vs_baseline": head["vs_baseline"],
        "vs_ceiling": head.get("vs_ceiling"),
        "north_star": NORTH_STAR_NOTE,
        "rows": [
            {"config": label, "value": r["value"], "vs_baseline": r["vs_baseline"],
             "ceiling": r.get("ceiling"), "vs_ceiling": r.get("vs_ceiling"),
             "meta": {k: v for k, v in r.items() if k.startswith("_")}}
            for r, label, _ in done
        ],
    }
    errors = []
    if dropped:
        errors.append(f"rows dropped: {'; '.join(dropped)} (see stderr)")
    if aborted:
        errors.append(f"suite truncated: {aborted}")
    if errors:
        out["error"] = "; ".join(errors)
    _emit(out)
    record_last_measured(out)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())

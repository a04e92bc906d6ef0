"""Agent wiring shared by the agents: port of
cartpoleplusplus_tpu.agents.common — the CLI flag groups, the vector-env
construction, greedy evaluation, the schedule and replay-sizing helpers,
the checkpoint startup (restore-if-present, ``--ckpt-best``,
``--eval-only``), the greedy policy as a module (:class:`GreedyPolicy`),
the greedy episodes ``--event-log-out`` records
(:func:`record_eval_episodes`), the artifact ``--export-policy`` writes
(:func:`maybe_export_policy`), and the data-parallel wiring of every agent's
``train`` (``--num-devices``, ``--coordinator/--num-processes/--process-id``:
:func:`maybe_init_multihost` and the rank helpers over ``parallel/``).

Every JAX flag is parsed with its name, default and choices; none is
ignored.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Callable

import torch
from torch import nn

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env import config as env_config
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.parallel.mesh import Mesh, current_mesh
from cartpoleplusplus_tpu_torch.physics import cuda_step
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.render import prefer_raster
from cartpoleplusplus_tpu_torch.render.cuda_render import Renderer
from cartpoleplusplus_tpu_torch.utils import checkpoint


def add_agent_opts(parser: argparse.ArgumentParser) -> None:
    """Flags shared by every agent main (the JAX ``add_agent_opts``: same
    names, defaults and choices), plus ``--device``."""
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-train-batches", type=int, default=200,
                        help="number of training segments")
    parser.add_argument("--num-envs", type=int, default=64,
                        help="vectorized env replicas")
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--gamma", type=float, default=0.99, help="discount factor")
    parser.add_argument("--eval-freq", type=int, default=20,
                        help="segments between greedy eval rollouts")
    parser.add_argument("--num-eval", type=int, default=16, help="episodes per eval")
    parser.add_argument("--ckpt-dir", type=str, default=None)
    parser.add_argument("--ckpt-freq", type=int, default=50,
                        help="segments between checkpoints")
    parser.add_argument("--ckpt-skip-replay", action="store_true",
                        help="checkpoint without the replay contents; on resume the "
                             "buffer restarts empty and re-warms before training")
    parser.add_argument("--ckpt-best", action="store_true",
                        help="also keep ckpt_best.pt, the state at the best eval "
                             "episode length so far; --eval-only --ckpt-best "
                             "restores it instead of the latest checkpoint")
    parser.add_argument("--event-log-out", type=str, default=None,
                        help="after training (or --eval-only), record greedy episodes "
                             "to this event log")
    parser.add_argument("--eval-only", action="store_true",
                        help="restore the latest --ckpt-dir checkpoint and run the "
                             "greedy eval without training")
    parser.add_argument("--export-policy", type=str, default=None,
                        help="after training (or under --eval-only), export the greedy "
                             "policy as a self-contained torch.export artifact (.pt2; "
                             "uint8 frames in for pixel configs, float32 for low-dim)")
    parser.add_argument("--metrics-jsonl", type=str, default=None,
                        help="structured metrics sink")
    parser.add_argument("--tb-dir", type=str, default=None,
                        help="also write numeric metrics as TensorBoard scalars to this "
                             "logdir (needs the tensorboard package; without it a "
                             "warning, and the jsonl and stderr sinks go on)")
    parser.add_argument("--hidden", type=int, nargs="+", default=[100, 50])
    parser.add_argument("--pixel-encoder", type=str, default="dense",
                        choices=["dense", "conv"],
                        help="pixel trunk: dense embedding of the flat frames, or "
                             "the conv stack")
    parser.add_argument("--pixel-pool", type=int, default=1,
                        help="k×k average-pool frames inside the network, before "
                             "its pixel encoder")
    parser.add_argument("--pallas-physics", action="store_true",
                        help="accepted for the JAX recipes; the port always runs "
                             "its CUDA physics kernels on the card")
    parser.add_argument("--pallas-render", action="store_true",
                        help="accepted for the JAX recipes; the port always runs "
                             "its CUDA render kernels on the card")
    parser.add_argument("--render-raster", action="store_true", default=None,
                        help="render by the projective raster (K5a) instead of the "
                             "slab cascade.  Default: per config (prefer_raster: "
                             "raster for exact configs, slab for sampled ones)")
    parser.add_argument("--no-render-raster", dest="render_raster", action="store_false",
                        help="force the slab cascade")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-process coordinator address host:port")
    parser.add_argument("--num-processes", type=int, default=1,
                        help="launcher processes in the job (one per host); each starts "
                             "--num-devices / --num-processes ranks")
    parser.add_argument("--process-id", type=int, default=0,
                        help="this process's rank in [0, num-processes)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device: CUDA unless 'cpu' is asked for (the "
                             "kernels' plain versions run there)")


def make_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    env_config.add_opts(parser)
    add_agent_opts(parser)
    return parser


def add_per_opts(parser) -> None:
    """Prioritized-replay and n-step flags."""
    parser.add_argument("--per", action="store_true",
                        help="prioritized experience replay (proportional, with "
                             "importance-sampling correction)")
    parser.add_argument("--per-alpha", type=float, default=0.6,
                        help="priority exponent (0 = uniform ablation)")
    parser.add_argument("--per-beta0", type=float, default=0.4,
                        help="initial importance-sampling exponent")
    parser.add_argument("--per-eps", type=float, default=1e-2,
                        help="priority floor added to |TD|")
    parser.add_argument("--n-step", type=int, default=1,
                        help="multi-step TD target (needs the s2-free block replay)")


def add_ou_anneal_opts(parser) -> None:
    parser.add_argument("--ou-sigma-min", type=float, default=None,
                        help="anneal OU sigma linearly down to this value over "
                             "--ou-decay-steps vectorized env steps")
    parser.add_argument("--ou-decay-steps", type=int, default=0,
                        help="vectorized steps over which --ou-sigma anneals to "
                             "--ou-sigma-min (0 = constant sigma)")


def add_lr_schedule_opt(parser) -> None:
    parser.add_argument("--lr-schedule", type=str, default="const",
                        choices=["const", "cosine"],
                        help="cosine: decay the learning rate to 2%% over the run")


# The output flags of a run: one writer, rank 0 (maybe_init_multihost).
OUTPUT_FLAGS = ("metrics_jsonl", "tb_dir", "event_log_out", "export_policy")


def maybe_init_multihost(opts) -> Mesh | None:
    """The JAX ``maybe_init_multihost`` contract, checked at the start of
    every agent's ``train`` → this process's mesh inside a rank, else None.

    Outside a rank, with ``--num-processes`` > 1: ``--coordinator`` is
    needed; ``--num-devices`` is the job-global rank count and must be > 1
    (and, in the port, a multiple of ``--num-processes``: each launcher
    starts as many ranks); ``--eval-only`` is refused (it needs no group:
    one process restores either kind of checkpoint).  Inside a rank > 0
    the output flags (:data:`OUTPUT_FLAGS`) are cleared, so the metrics,
    the TensorBoard logdir, the event log and the export have one writer,
    rank 0.  ``--ckpt-dir`` stays on every rank (rank files or a gathered
    global file, ``utils/checkpoint.py``)."""
    mesh = current_mesh()
    if mesh is not None:
        if mesh.rank > 0:
            for flag in OUTPUT_FLAGS:
                setattr(opts, flag, None)
        return mesh
    n = getattr(opts, "num_processes", 1) or 1
    if n <= 1:
        return None
    if not getattr(opts, "coordinator", None):
        raise SystemExit("--num-processes > 1 needs --coordinator host:port")
    devices = getattr(opts, "num_devices", 1)
    if devices <= 1:
        raise SystemExit("--num-processes > 1 needs --num-devices set to the job-global "
                         "device count (the mesh spans every process's chips)")
    if getattr(opts, "eval_only", False):
        raise SystemExit("--eval-only needs no mesh: run it single-process (params restore "
                         "from either checkpoint flavor's rank-0/global file)")
    if devices % n:
        raise SystemExit("--num-devices must be a multiple of --num-processes (each process "
                         "starts --num-devices / --num-processes ranks)")
    if not 0 <= getattr(opts, "process_id", 0) < n:
        raise SystemExit("--process-id must lie in [0, --num-processes)")
    return None


def launches_ranks(opts, mesh: Mesh | None, replay: bool = True) -> bool:
    """Whether this ``train`` call starts ranks (``parallel.launch``)
    instead of training: ``--num-devices`` > 1 outside a rank, unless
    ``--eval-only``, which one process serves.  Refuses, as the JAX CLIs
    do, an env count (and with ``replay`` a replay capacity) that
    ``--num-devices`` does not divide."""
    n = getattr(opts, "num_devices", 1)
    if mesh is not None or n <= 1 or getattr(opts, "eval_only", False):
        return False
    if replay and (opts.num_envs % n or opts.replay_capacity % n):
        raise SystemExit("--num-envs and --replay-capacity must be divisible by --num-devices")
    if opts.num_envs % n:
        raise SystemExit("--num-envs must be divisible by --num-devices")
    return True


def rank_device(opts, mesh: Mesh | None) -> torch.device:
    """The device this process trains on: its rank's, else the run's."""
    return mesh.device if mesh is not None else resolve_device(opts.device)


def rank_batch(opts, mesh: Mesh | None) -> int:
    """The per-rank replay batch, ``--batch-size // world or 1`` (JAX's
    per-chip batch)."""
    return opts.batch_size if mesh is None else opts.batch_size // mesh.world or 1


def rank_venvs(config, opts, device, raster: bool, mesh: Mesh | None):
    """(venv, init_venv): the training venv of this rank's env shard
    (``--num-envs // world``) and the venv whose reset starts the run.  On
    one device they are one venv; on a rank ``init_venv`` holds the whole
    job's envs, which every rank resets from ``--seed`` before it keeps its
    own rows (``parallel.shard_state``), so N ranks start from exactly the
    states one rank starts from."""
    world = 1 if mesh is None else mesh.world
    venv = make_venv(config, opts.num_envs // world, device=device, render_raster=raster)
    if world == 1:
        return venv, venv
    return venv, make_venv(config, opts.num_envs, device=device, render_raster=raster)


def shard_start(st, mesh: Mesh | None, sharded: tuple) -> None:
    """On a rank, make the freshly built global state this rank's
    (``parallel.shard_state``)."""
    if mesh is not None:
        distributed.shard_state(st, mesh, sharded)


def distribute(segment, mesh: Mesh | None, sharded: tuple, metric_keys: tuple):
    """On a rank, the distributed form of a per-rank segment or update
    (``parallel.make_distributed``); the segment itself on one device."""
    if mesh is None:
        return segment
    return distributed.make_distributed(mesh, segment, sharded, metric_keys)[0]


def resolve_render_raster(config, opts) -> bool:
    """Resolve the ``--render-raster`` tristate on ``opts`` (None → the
    per-config pick, :func:`prefer_raster`; always False for low-dim
    configs unless asked for, which ``make_venv`` refuses).  The JAX
    package also probes the raster kernel here and downgrades to the slab
    kernel when the backend rejects it; the port does not: a raster kernel
    that fails to build or launch is an error."""
    if opts.render_raster is None:
        opts.render_raster = config.use_raw_pixels and prefer_raster(
            config.num_cameras, config.obs_pool, config.obs_samples)
    return opts.render_raster


def make_venv(config, num_envs: int, device=None, render_raster: bool | None = None,
              render_recip: bool = True, render_hoist: bool = False,
              render_mxu: bool = False) -> VectorCartpole:
    """Vector env wired to the kernels, as the JAX ``make_venv`` wires its
    Pallas kernels with the fused step on.  Pixel configs:

    - reset push: K2 (``cuda_step.step_substeps``);
    - reset frame: K4 (``Renderer.render_batched``);
    - step: K1 (``cuda_step.step_repeats``) then K3
      (``Renderer.render_repeats``) over all repeats.

    Low-dim configs: the reset push is K2, the reset frame
    :func:`cartpole.observe_lowdim`, and the step one K1 launch whose
    per-repeat poses are the frames, where the JAX
    venv makes one K2 launch and one ``observe_lowdim`` per repeat
    (:func:`cartpole.simulate_repeats`); the two give the same numbers.

    ``render_raster=None`` resolves through :func:`prefer_raster`: the
    raster mode (K5a, in both render launches) for exact configs
    (``obs_samples == 0``), the slab mode for sampled ones.  The other
    flags are the JAX package's, with its defaults and meaning: in the slab
    mode ``render_recip=False`` casts with the division-free ratio cascade
    (K5b); in the raster mode ``render_hoist`` packs the per-env setup in a
    pass of its own first (K5c) and ``render_mxu`` computes the bound planes
    as one tensor-core product (K5d), alone or together.  A low-dim config
    renders nothing, and a render flag away from its default raises there.
    Nothing falls back: a kernel that fails to build or launch raises.  On
    a CPU device each wrapper runs its plain PyTorch version.
    """
    dev = resolve_device(device)
    if not config.use_raw_pixels:
        if render_raster or not render_recip or render_hoist or render_mxu:
            raise ValueError("render options select a render kernel; a low-dim config "
                             "renders nothing")

        def lowdim_sim_fn(scene, rigid, force):
            rigid, poses = cuda_step.step_repeats(
                scene, rigid, force, config.steps_per_repeat, config.action_repeats
            )
            # Pose columns [cart pos quat | pole pos quat | 0 0] (R, E, 16)
            # → each repeat's observe_lowdim frame, (E, R, 2, 7).
            r, e = poses.shape[:2]
            return rigid, poses[..., :14].reshape(r, e, 2, 7).transpose(0, 1)

        return VectorCartpole(config, num_envs, physics_fn=cuda_step.step_substeps,
                              observe_fn=cartpole.observe_lowdim, sim_fn=lowdim_sim_fn,
                              device=dev)
    if render_raster is None:
        render_raster = prefer_raster(config.num_cameras, config.obs_pool, config.obs_samples)
    renderer = Renderer(config, dev, raster=render_raster, recip=render_recip,
                        hoist=render_hoist, mxu=render_mxu)

    def sim_fn(scene, rigid, force):
        rigid, poses = cuda_step.step_repeats(
            scene, rigid, force, config.steps_per_repeat, config.action_repeats
        )
        return rigid, renderer.render_repeats(scene, poses)

    return VectorCartpole(config, num_envs, physics_fn=cuda_step.step_substeps,
                          observe_fn=renderer.render_batched, sim_fn=sim_fn, device=dev)


def ou_sigma_at(env_steps: int, sigma: float, sigma_min: float | None,
                decay_steps: int) -> float:
    """Annealed OU sigma at vectorized step ``env_steps``: a linear ramp
    sigma → sigma_min over ``decay_steps``, constant when annealing is off.
    The step counter is a host int, so this is a host float."""
    if not decay_steps or sigma_min is None or sigma_min == sigma:
        return sigma
    frac = min(max(env_steps / decay_steps, 0.0), 1.0)
    return sigma + (sigma_min - sigma) * frac


def make_lr(opts, lr: float, total_updates: int | None = None):
    """Learning rate per ``opts.lr_schedule``: ``lr`` for "const", or for
    "cosine" a function of the update count (optax's
    ``cosine_decay_schedule(lr, total_updates, alpha=0.02)``), to be read
    before each optimizer step.  ``total_updates`` defaults to the
    off-policy agents' optimizer steps, segments × steps per segment."""
    if getattr(opts, "lr_schedule", "const") != "cosine":
        return lr
    if total_updates is None:
        total_updates = opts.num_train_batches * opts.steps_per_segment
    total = max(total_updates, 1)

    def schedule(count: int) -> float:
        frac = min(count, total) / total
        return lr * (0.98 * 0.5 * (1.0 + math.cos(math.pi * frac)) + 0.02)

    return schedule


def replay_capacity(capacity: int, block: int) -> int:
    """The s2-free replay's capacity: trimmed down to a multiple of its
    insertion block, as the JAX ``replay.create`` trims it (the default
    100000 is no multiple of the default 64 envs)."""
    if not block or capacity % block == 0:
        return capacity
    trimmed = (capacity // block) * block
    if trimmed <= block:
        raise SystemExit(f"--replay-capacity {capacity} holds fewer than two blocks of "
                         f"{block} transitions (one per env)")
    print(f"# replay: capacity {capacity} -> {trimmed} (multiple of insertion block {block})",
          file=sys.stderr)
    return trimmed


def replay_block(opts, num_envs: int) -> int:
    """Insertion-block size for the s2-free replay: one vectorized step's
    transitions per device shard (``num_envs`` and the capacity divided by
    ``--num-devices``), or 0 (explicit s2) when a shard's capacity cannot
    hold two blocks."""
    devices = max(getattr(opts, "num_devices", 1), 1)
    local_envs, local_cap = num_envs // devices, opts.replay_capacity // devices
    return local_envs if 0 < local_envs < local_cap else 0


def shard_capacity(opts, block: int) -> int:
    """The replay capacity of a state built for the whole job: each of the
    ``--num-devices`` shards holds ``--replay-capacity / --num-devices``
    trimmed to a multiple of its insertion block (:func:`replay_capacity`),
    so every shard's ring is whole."""
    devices = max(getattr(opts, "num_devices", 1), 1)
    return replay_capacity(opts.replay_capacity // devices, block) * devices


def replay_min_fill(warmup_steps: int, num_envs: int, capacity: int, n_step: int = 1) -> int:
    """Transitions the replay must hold before the train gate may open:
    a fresh run's first train step (``(warmup + 1)·num_envs``, capped one
    block below capacity), and at least ``n_step + 1`` blocks so the
    newest blocks, which ``sample`` excludes, are never all there is."""
    fresh = min((warmup_steps + 1) * num_envs, capacity - num_envs)
    floor = min((n_step + 1) * num_envs, capacity)
    return max(fresh, floor)


def check_nstep_capacity(opts, replay) -> None:
    """The JAX ``ddpg.train``'s startup checks for ``--n-step`` > 1: the
    replay must be s2-free (block mode) and hold at least n + 1 blocks, or
    the window of sampleable rows degenerates (a row's n-step successor
    unwritten, or the row itself once the stride wraps the ring)."""
    n = getattr(opts, "n_step", 1)
    if n <= 1:
        return
    if not replay.block:
        raise SystemExit("--n-step > 1 needs the s2-free block replay (capacity must hold at "
                         "least two num-envs blocks per device shard)")
    if replay.capacity < (n + 1) * replay.block:
        raise SystemExit(f"--n-step {n} needs replay capacity >= {n + 1} blocks of num-envs "
                         f"transitions per device shard (got {replay.capacity} < "
                         f"{(n + 1) * replay.block})")


@torch.no_grad()
def eval_rollout(
    venv: VectorCartpole,
    act_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy eval, one episode per env slot → (mean episode len, mean reward).

    ``act_fn`` maps obs (E, …) to actions; ``generator`` drives the reset.
    Runs ``max_episode_len`` steps with no auto-reset; an env stops
    counting once done.
    """
    states, obs = venv.reset(generator)
    e = venv.num_envs
    ep_len = torch.zeros((e,), dtype=torch.int32, device=venv.device)
    ep_rew = torch.zeros((e,), dtype=torch.float32, device=venv.device)
    alive = torch.ones((e,), dtype=torch.bool, device=venv.device)
    for _ in range(venv.config.max_episode_len):
        action = act_fn(obs)
        states, obs, reward, done = cartpole.step_batched(
            venv.config, venv.scene, states, action, venv.sim_fn)
        ep_len = ep_len + alive.to(torch.int32)
        ep_rew = ep_rew + reward * alive
        alive = alive & ~done
    return ep_len.to(torch.float32).mean(), ep_rew.mean()


class BestCkptKeeper:
    """``--ckpt-best``: keep the state at the best eval so far.

    ``update`` is called after every eval and writes ``ckpt_best.pt`` only
    on improvement.  On resume the meta embedded in that file seeds the
    gate, so a restart cannot clobber a better historical best with an
    early worse one.  Off unless ``--ckpt-dir`` and ``--ckpt-best``, and
    always off under ``--num-processes`` > 1 (rank files of a best state
    would need their own completeness rule).  Under one launcher of
    several ranks every rank calls ``update`` with rank 0's eval, the state
    is gathered and rank 0 writes it (``mesh``, ``sharded``)."""

    def __init__(self, opts, mesh: Mesh | None = None, sharded: tuple = ()):
        self.on = bool(getattr(opts, "ckpt_dir", None) and getattr(opts, "ckpt_best", False)
                       and getattr(opts, "num_processes", 1) <= 1)
        self.best = float("-inf")
        self._opts, self._mesh, self._sharded = opts, mesh, sharded
        if self.on:
            meta = checkpoint.best_meta(opts.ckpt_dir)
            if meta is not None:
                self.best = float(meta["eval_ep_len"])

    def update(self, step: int, eval_len: float, st) -> None:
        if self.on and eval_len > self.best:
            self.best = eval_len
            skip = getattr(self._opts, "ckpt_skip_replay", False)
            tree = job_state(st, self._mesh, self._sharded, skip)
            if tree is not None:
                checkpoint.save_best(self._opts.ckpt_dir, step, eval_len, tree, skip_replay=skip)


def restore_for_startup(opts, st, mesh: Mesh | None = None):
    """Restore-if-present: ``ckpt_best.pt`` for ``--eval-only --ckpt-best``,
    the newest numbered checkpoint otherwise, and on a rank this rank's
    part of the newest rank files or global file
    (``checkpoint.restore_latest_sharded``) → (st, step or None)."""
    if mesh is not None:
        return checkpoint.restore_latest_sharded(opts.ckpt_dir, st, mesh)
    if getattr(opts, "eval_only", False) and getattr(opts, "ckpt_best", False):
        return checkpoint.restore_best(opts.ckpt_dir, st)
    return checkpoint.restore_latest(opts.ckpt_dir, st)


def run_eval_only(opts, logger, restored_step, eval_venv: VectorCartpole,
                  act_fn: GreedyPolicy) -> float:
    """``--eval-only``: one greedy eval of the restored policy (generator
    seeded from ``--seed`` + 1, as the training loop's evals are), logged as
    an ``eval_only`` event, then :func:`run_tail`; nothing is trained.
    Nothing restored is a hard error: evaluating fresh random weights would
    read as a regressed policy."""
    if restored_step is None:
        raise SystemExit("--eval-only needs --ckpt-dir pointing at a restorable checkpoint")
    gen = torch.Generator(device=eval_venv.device).manual_seed(opts.seed + 1)
    elen, erew = eval_rollout(eval_venv, act_fn, gen)
    logger.log("eval_only", segment=restored_step, eval_ep_len=float(elen),
               eval_ep_rew=float(erew))
    run_tail(opts, eval_venv, act_fn, logger)
    return float(elen)


class GreedyPolicy(nn.Module):
    """A network's greedy action as a module: ``forward(obs)`` is
    ``head(net, obs, **buffers)``, computed without autograd.  ``net`` is
    held, not copied, so the policy acts with the weights training has
    reached; ``buffers`` are tensors the head reads (C51's support), which
    move with the module.  Each agent's ``greedy_act`` builds one; the
    evals call it, and ``--export-policy`` exports it
    (:func:`maybe_export_policy`)."""

    def __init__(self, net: nn.Module, head: Callable, **buffers: torch.Tensor):
        super().__init__()
        self.net, self._head = net, head
        for name, value in buffers.items():
            self.register_buffer(name, value, persistent=False)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._head(self.net, obs, **dict(self.named_buffers(recurse=False)))


def maybe_export_policy(opts, config, act_module: GreedyPolicy, logger) -> None:
    """``--export-policy``: write the greedy policy's serving artifact
    (:func:`utils.export.save_policy`) with the training pipeline's
    observation ABI, uint8 frames for pixel configs and float32 for
    low-dim, and log an ``export_policy`` event of its path and bytes."""
    path = getattr(opts, "export_policy", None)
    if not path:
        return
    from cartpoleplusplus_tpu_torch.utils import export

    obs_dtype = torch.uint8 if config.use_raw_pixels else torch.float32
    nbytes = export.save_policy(path, act_module, config.obs_shape, obs_dtype)
    logger.log("export_policy", path=path, bytes=nbytes)


def record_eval_episodes(config, act_fn: Callable[[torch.Tensor], torch.Tensor], path: str,
                         num_episodes: int = 3, seed: int = 0, raster: bool = False,
                         device=None) -> list[int]:
    """Record ``num_episodes`` greedy episodes to the event log at ``path``
    → their lengths.

    Each episode is rolled on the per-env step (the AoS engine) through
    ``random_agent.run_episode``, which owns the event convention (post-step
    poses, velocity rows, done flags), with ``act_fn`` (obs (E, …) →
    actions, given one env's obs as a batch of one) for its random draws;
    the resets draw from a generator seeded with ``seed``.  Pixel configs
    observe through the render kernels at one env
    (``gym_env.pixel_observers``) in the training run's cast mode,
    ``raster``.  GIFs then come from ``python -m
    cartpoleplusplus_tpu_torch.utils.event_log --log-file X --gif-out D``.
    """
    from cartpoleplusplus_tpu_torch.agents.random_agent import run_episode
    from cartpoleplusplus_tpu_torch.env.gym_env import pixel_observers
    from cartpoleplusplus_tpu_torch.utils.event_log import EventLog

    dev = resolve_device(device)
    scene = cartpole.scene_for(config)
    reset_observe, step_observe = pixel_observers(config, dev, raster)
    reset_fn = lambda g: cartpole.reset(config, scene, g, reset_observe, device=dev)
    step_fn = lambda s, a: cartpole.step(config, scene, s, a, step_observe)
    policy = lambda obs: act_fn(obs[None])[0]
    generator = torch.Generator(device=dev).manual_seed(seed)
    log = EventLog(path)
    lengths = []
    for _ in range(num_episodes):
        steps, _, events = run_episode(config, scene, step_fn, reset_fn, generator,
                                       collect=True, policy=policy)
        log.add_episode(events)
        lengths.append(steps)
    log.close()
    return lengths


def run_tail(opts, eval_venv: VectorCartpole, act_fn: GreedyPolicy, logger) -> None:
    """The end of a run (after training or ``--eval-only``): with
    ``--event-log-out`` greedy episodes of ``act_fn`` recorded on the eval
    env's config and device (:func:`record_eval_episodes`, seeded from
    ``--seed``) and an ``event_log`` event of their count and lengths, then
    :func:`maybe_export_policy`; closes ``logger``."""
    if getattr(opts, "event_log_out", None):
        lengths = record_eval_episodes(eval_venv.config, act_fn, opts.event_log_out,
                                       seed=opts.seed,
                                       raster=bool(getattr(opts, "render_raster", False)),
                                       device=eval_venv.device)
        logger.log("event_log", episodes=len(lengths), lengths=lengths)
    maybe_export_policy(opts, eval_venv.config, act_fn, logger)
    logger.close()


_RIGID = ("pos", "quat", "vel", "ang")
_REPLAY_DATA = ("s1", "action", "reward", "s2", "terminal", "priority")


def env_state_dict(st) -> dict:
    """The env states, ``obs`` and the generator's state a training state
    carries, as checkpoint entries (live tensor references)."""
    e = st.env_states
    return {
        "env_states": {**{k: getattr(e.rigid, k) for k in _RIGID}, "steps": e.steps,
                       "done": e.done},
        "obs": st.obs, "generator": st.generator.get_state(),
    }


def load_env_state(st, sd: dict) -> None:
    """Restore :func:`env_state_dict`'s entries into ``st`` in place, onto
    its device."""
    dev = st.obs.device
    e = sd["env_states"]
    st.env_states = EnvState(rigid=RigidState(**{k: e[k].to(dev) for k in _RIGID}),
                             steps=e["steps"].to(dev), done=e["done"].to(dev))
    st.obs = sd["obs"].to(dev)
    st.generator.set_state(sd["generator"])


def carried_state_dict(st) -> dict:
    """What every off-policy agent's training state carries besides its
    networks, as checkpoint entries (live tensor references and host ints):
    the replay with its cursor, fill and block, :func:`env_state_dict`'s
    entries and ``env_steps``."""
    r = st.replay
    return {
        "replay": {**{k: getattr(r, k) for k in _REPLAY_DATA}, "cursor": r.cursor,
                   "size": r.size, "block": r.block},
        **env_state_dict(st), "env_steps": st.env_steps,
    }


def load_carried_state(st, sd: dict) -> None:
    """Restore :func:`carried_state_dict`'s entries into ``st`` in place,
    onto its device."""
    r = sd["replay"]
    for k in _REPLAY_DATA:
        getattr(st.replay, k).copy_(r[k])
    st.replay.cursor, st.replay.size = int(r["cursor"]), int(r["size"])
    load_env_state(st, sd)
    st.env_steps = int(sd["env_steps"])


def replay_fields(metric_keys: tuple) -> Callable[[dict], dict]:
    """DDPG's and SAC's ``train``-event fields after ``env_steps``, read
    from a segment's metrics: the agent's ``metric_keys``, then
    ``mean_reward`` and ``double_reset_frac``."""

    def fields(metrics: dict) -> dict:
        return {**{k: float(metrics[k]) for k in metric_keys},
                "mean_reward": float(metrics["reward"]),
                "double_reset_frac": float(metrics["double_reset_frac"])}

    return fields


def _eval(eval_venv: VectorCartpole, act_fn, gen: torch.Generator, mesh: Mesh | None):
    """The training loop's greedy eval (:func:`eval_rollout`); on a rank,
    rank 0 evaluates and broadcasts its result, so every rank logs and
    gates ``--ckpt-best`` on one number."""
    if mesh is None:
        return eval_rollout(eval_venv, act_fn, gen)
    out = eval_rollout(eval_venv, act_fn, gen) if mesh.rank == 0 else (0.0, 0.0)
    return tuple(distributed.broadcast_floats(mesh, out))


def job_state(st, mesh: Mesh | None, sharded: tuple, skip_replay: bool):
    """What a one-launcher checkpoint holds: ``st`` on one device; on a rank
    the job's gathered state dict on rank 0 and None on the others (every
    rank must call this), the replay stripped before the gather with
    ``skip_replay``."""
    if mesh is None:
        return st
    return distributed.global_state_dict(
        checkpoint.strip_replay(st.state_dict()) if skip_replay else st, mesh, sharded)


def save_checkpoint(opts, step: int, st, mesh: Mesh | None, sharded: tuple) -> None:
    """``ckpt_<step>``: the one file of :func:`job_state` (on a rank,
    written by rank 0), or under ``--num-processes`` > 1 every rank's own
    rank file."""
    skip = opts.ckpt_skip_replay
    if mesh is not None and getattr(opts, "num_processes", 1) > 1:
        checkpoint.save_rank(opts.ckpt_dir, step, st, mesh.rank, mesh.world, skip_replay=skip)
        return
    tree = job_state(st, mesh, sharded, skip)
    if tree is not None:
        checkpoint.save(opts.ckpt_dir, step, tree, skip_replay=skip)


def train_segments(opts, st, segment, venv: VectorCartpole, eval_venv: VectorCartpole,
                   act_fn: Callable[[torch.Tensor], torch.Tensor], logger,
                   fields: Callable[[dict], dict], start: int, end: int,
                   mesh: Mesh | None = None, sharded: tuple = ()) -> float:
    """The JAX ``train``'s loop over segments ``start .. end`` → the last
    eval's mean episode length.  A greedy eval every ``--eval-freq``
    segments and at the last (generator seeded from ``--seed`` + 1; the
    segment's metrics are read from the card there only), logged as a
    ``train`` event of ``segment``, ``env_steps`` (the whole job's),
    the agent's ``fields(metrics)`` (:func:`replay_fields` for DDPG and
    SAC), ``eval_ep_len`` and ``eval_ep_rew``; ``ckpt_<segment>`` every
    ``--ckpt-freq`` and at the end (:func:`save_checkpoint`); ``ckpt_best``
    on improvement with ``--ckpt-best``; then :func:`run_tail`, which
    closes ``logger``.  On a rank (``mesh``) the eval is rank 0's
    (:func:`_eval`) and ``sharded`` names the state's sharded fields."""
    gen = torch.Generator(device=eval_venv.device).manual_seed(opts.seed + 1)
    best = BestCkptKeeper(opts, mesh, sharded)
    world = 1 if mesh is None else mesh.world
    final_eval = 0.0
    for i in range(start, end):
        metrics = segment(st)
        if (i + 1) % max(opts.eval_freq, 1) == 0 or i + 1 == end:
            elen, erew = _eval(eval_venv, act_fn, gen, mesh)
            final_eval = float(elen)
            best.update(i + 1, final_eval, st)
            logger.log("train", segment=i + 1,
                       env_steps=st.env_steps * venv.num_envs * world,
                       **fields(metrics), eval_ep_len=float(elen), eval_ep_rew=float(erew))
        if opts.ckpt_dir and (i + 1) % max(opts.ckpt_freq, 1) == 0:
            save_checkpoint(opts, i + 1, st, mesh, sharded)
    if opts.ckpt_dir:
        save_checkpoint(opts, max(end, start), st, mesh, sharded)
    run_tail(opts, eval_venv, act_fn, logger)
    return final_eval


def train_updates(opts, st, train_step, eval_venv: VectorCartpole,
                  act_fn: Callable[[torch.Tensor], torch.Tensor], logger,
                  fields: Callable[[int, dict], dict], start: int, end: int,
                  mesh: Mesh | None = None, sharded: tuple = ()) -> float:
    """The on-policy agents' loop (the JAX PPO and LRPG ``train``): updates
    ``start .. end`` of ``train_step(st) -> metrics``, each advancing
    ``st.update`` → the last eval's mean episode length.  A greedy eval
    every ``--eval-freq`` updates and at the last (generator seeded from
    ``--seed`` + 1; the update's metrics are read from the card there
    only), logged as a ``train`` event of ``update``, the agent's
    ``fields(update, metrics)``, ``eval_ep_len`` and ``eval_ep_rew``;
    ``ckpt_<update>`` every ``--ckpt-freq`` and at the end;
    ``ckpt_best`` on improvement with ``--ckpt-best``; then
    :func:`run_tail`, which closes ``logger``.  ``mesh`` and ``sharded`` as
    in :func:`train_segments`."""
    gen = torch.Generator(device=eval_venv.device).manual_seed(opts.seed + 1)
    best = BestCkptKeeper(opts, mesh, sharded)
    final_eval = 0.0
    for i in range(start, end):
        metrics = train_step(st)
        if (i + 1) % max(opts.eval_freq, 1) == 0 or i + 1 == end:
            elen, erew = _eval(eval_venv, act_fn, gen, mesh)
            final_eval = float(elen)
            best.update(i + 1, final_eval, st)
            logger.log("train", update=i + 1, **fields(i + 1, metrics),
                       eval_ep_len=float(elen), eval_ep_rew=float(erew))
        if opts.ckpt_dir and (i + 1) % max(opts.ckpt_freq, 1) == 0:
            save_checkpoint(opts, i + 1, st, mesh, sharded)
    if opts.ckpt_dir:
        save_checkpoint(opts, max(end, start), st, mesh, sharded)
    run_tail(opts, eval_venv, act_fn, logger)
    return final_eval

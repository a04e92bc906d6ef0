"""Agent wiring shared by the agents: port of the vector-env construction,
greedy evaluation and the schedule and replay-sizing helpers of
cartpoleplusplus_tpu.agents.common."""

from __future__ import annotations

import math
from typing import Callable

import torch

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole
from cartpoleplusplus_tpu_torch.physics import cuda_step
from cartpoleplusplus_tpu_torch.render import prefer_raster
from cartpoleplusplus_tpu_torch.render.cuda_render import Renderer


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


def make_lr(opts, lr: float):
    """Learning rate per ``opts.lr_schedule``: ``lr`` for "const", or for
    "cosine" a function of the update count (optax's
    ``cosine_decay_schedule(lr, total_updates, alpha=0.02)``), to be read
    before each optimizer step."""
    if getattr(opts, "lr_schedule", "const") != "cosine":
        return lr
    total = max(opts.num_train_batches * opts.steps_per_segment, 1)

    def schedule(count: int) -> float:
        frac = min(count, total) / total
        return lr * (0.98 * 0.5 * (1.0 + math.cos(math.pi * frac)) + 0.02)

    return schedule


def replay_block(opts, num_envs: int) -> int:
    """Insertion-block size for the s2-free replay: one vectorized step's
    transitions, or 0 (explicit s2) when the capacity cannot hold two
    blocks.  The port runs on one card, so there are no device shards."""
    return num_envs if 0 < num_envs < opts.replay_capacity else 0


def replay_min_fill(warmup_steps: int, num_envs: int, capacity: int, n_step: int = 1) -> int:
    """Transitions the replay must hold before the train gate may open:
    a fresh run's first train step (``(warmup + 1)·num_envs``, capped one
    block below capacity), and at least ``n_step + 1`` blocks so the
    newest blocks, which ``sample`` excludes, are never all there is."""
    fresh = min((warmup_steps + 1) * num_envs, capacity - num_envs)
    floor = min((n_step + 1) * num_envs, capacity)
    return max(fresh, floor)


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

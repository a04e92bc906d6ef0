"""Agent wiring shared by the agents: port of the vector-env construction
and greedy evaluation of cartpoleplusplus_tpu.agents.common."""

from __future__ import annotations

from typing import Callable

import torch

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole
from cartpoleplusplus_tpu_torch.physics import cuda_step
from cartpoleplusplus_tpu_torch.render import prefer_raster
from cartpoleplusplus_tpu_torch.render.cuda_render import SlabRenderer


def make_venv(config, num_envs: int, device=None) -> VectorCartpole:
    """Vector env wired to the kernels, as the JAX ``make_venv`` wires its
    Pallas kernels with the fused step on:

    - reset push: K2 (``cuda_step.step_substeps``);
    - reset frame: K4 (``SlabRenderer.render_batched``);
    - step: K1 (``cuda_step.step_repeats``) then K3
      (``SlabRenderer.render_repeats``) over all repeats.

    On a CPU device each wrapper runs its plain PyTorch version.  Low-dim
    configs and exact pixel configs (``obs_samples == 0``, raster mode)
    are not ported yet.
    """
    dev = resolve_device(device)
    if not config.use_raw_pixels:
        raise NotImplementedError("low-dim observations are not ported yet")
    if prefer_raster(config.num_cameras, config.obs_pool, config.obs_samples):
        raise NotImplementedError(
            "exact pixel configs (obs_samples == 0) render in the raster mode, "
            "which is not ported yet"
        )
    renderer = SlabRenderer(config, dev)

    def sim_fn(scene, rigid, force):
        rigid, poses = cuda_step.step_repeats(
            scene, rigid, force, config.steps_per_repeat, config.action_repeats
        )
        return rigid, renderer.render_repeats(scene, poses)

    return VectorCartpole(config, num_envs, physics_fn=cuda_step.step_substeps,
                          observe_fn=renderer.render_batched, sim_fn=sim_fn, device=dev)


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

"""Vectorized auto-resetting env: port of cartpoleplusplus_tpu.env.vector.

Auto-reset semantics: when an env reports done, the returned obs/reward
are the terminal ones (the transition the learner sees), while the carried
state and the observation to act on next come from a fresh reset.
``step_lazy`` leaves the observation substitution to the consumer
(:func:`resolve_obs`), so the full obs slab is not rewritten every step.
"""

from __future__ import annotations

from typing import Optional

import torch

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig


def _where_state(pred: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-env select between two batched states."""

    def sel(x, y):
        return torch.where(pred.reshape(pred.shape + (1,) * (x.dim() - 1)), x, y)

    return EnvState(
        rigid=a.rigid.map(sel, b.rigid), steps=sel(a.steps, b.steps), done=sel(a.done, b.done)
    )


def resolve_obs(done: torch.Tensor, reset_obs: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """``reset_obs`` where ``done`` else ``obs``, applied at the consumer.

    A reset pool's frames are one frame repeated over the repeats, so only
    its first frame is read.
    """
    first = reset_obs[:, :1] if reset_obs.dim() == obs.dim() else reset_obs
    p = done.reshape(done.shape + (1,) * (obs.dim() - 1))
    return torch.where(p, first, obs)


class VectorCartpole:
    """Batched env bundling config, scene and the physics/observe hooks.

    ``physics_fn`` serves the reset push, ``observe_fn`` the reset frame,
    ``sim_fn`` the step over all repeats.  ``device`` defaults to CUDA.
    """

    def __init__(
        self,
        config: CartpoleConfig,
        num_envs: int,
        physics_fn,
        observe_fn,
        sim_fn,
        device=None,
    ):
        self.config = config
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.scene = cartpole.scene_for(config)
        self.physics_fn = physics_fn
        self.observe_fn = observe_fn
        self.sim_fn = sim_fn

    def reset(
        self,
        generator: Optional[torch.Generator] = None,
        theta: Optional[torch.Tensor] = None,
        jitter: Optional[torch.Tensor] = None,
    ) -> tuple[EnvState, torch.Tensor]:
        """Batched reset → (states, obs[num_envs, repeats, …])."""
        return cartpole.reset_batched(
            self.config, self.scene, self.num_envs, self.physics_fn, self.observe_fn,
            self.device, generator, theta, jitter,
        )

    def step(
        self,
        state: EnvState,
        action: torch.Tensor,
        reset_pool: tuple[EnvState, torch.Tensor],
    ) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Auto-resetting step → (states, obs, reward, done, next_obs).

        ``obs`` is the transition's s2 (terminal frame for done envs);
        ``next_obs`` the observation to act on next.  ``reset_pool`` is a
        precomputed ``reset()`` batch that done envs restart from (the JAX
        version can also draw a fresh one per step; not ported).
        """
        carried, obs, reward, done = self.step_lazy(state, action, reset_pool)
        return carried, obs, reward, done, resolve_obs(done, reset_pool[1], obs)

    def step_lazy(
        self,
        state: EnvState,
        action: torch.Tensor,
        reset_pool: tuple[EnvState, torch.Tensor],
    ) -> tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Auto-resetting step without substituting the obs →
        (carried_states, obs, reward, done); act next on
        ``resolve_obs(done, reset_pool[1], obs)``."""
        next_state, obs, reward, done = cartpole.step_batched(
            self.config, self.scene, state, action, self.sim_fn)
        carried = _where_state(done, reset_pool[0], next_state)
        return carried, obs, reward, done

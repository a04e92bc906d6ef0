"""DDPG acting: port of ``greedy_act`` from cartpoleplusplus_tpu.agents.ddpg.

Training (replay, critic, OU noise, the fused segment) is not ported yet.
"""

from __future__ import annotations

import torch

from cartpoleplusplus_tpu_torch.models.networks import Actor


def greedy_act(actor: Actor):
    """obs (E, …) → greedy actions µ(obs) (E, 2).  The JAX version takes
    ``(params, obs)``; here the parameters live in the module."""

    @torch.no_grad()
    def act(obs: torch.Tensor) -> torch.Tensor:
        return actor(obs)

    return act

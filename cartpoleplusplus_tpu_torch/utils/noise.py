"""Exploration noise: port of cartpoleplusplus_tpu.utils.noise (OU)."""

from __future__ import annotations

from typing import Optional

import torch


def ou_step(
    state: torch.Tensor,
    theta: float = 0.15,
    sigma: float = 0.2,
    mu: float = 0.0,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One Ornstein-Uhlenbeck update: x ← x + θ(µ−x) + σ·ε.

    ``eps``: pre-drawn standard normals of ``state``'s shape; drawn from
    ``generator`` when not given.
    """
    if eps is None:
        eps = torch.randn(state.shape, generator=generator, device=state.device,
                          dtype=state.dtype)
    return state + theta * (mu - state) + sigma * eps


def ou_init(shape, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)

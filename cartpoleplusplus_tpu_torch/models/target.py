"""Target-network updates: port of cartpoleplusplus_tpu.models.target."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def soft_target_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """target ← (1-τ)·target + τ·online over every parameter and buffer,
    in place (the JAX version returns a new tree)."""
    t = list(target.state_dict().values())
    o = list(online.state_dict().values())
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, o, alpha=tau)


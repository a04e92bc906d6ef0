"""Agent networks: port of the DDPG ``Actor`` and ``Critic`` of
cartpoleplusplus_tpu.models.networks, and the TD3 twin critic."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from cartpoleplusplus_tpu_torch import resolve_device
from cartpoleplusplus_tpu_torch.models.trunks import DEFAULT_HIDDEN, MLPTrunk, ObsEncoder


def final_layer_init(layer: nn.Linear, generator: torch.Generator | None = None,
                     scale: float = 3e-3) -> None:
    """Uniform ±``scale`` init of an output head (the DDPG paper's)."""
    with torch.no_grad():
        for p in (layer.weight, layer.bias):
            p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * scale)


def lecun_init(layer: nn.Linear, generator: torch.Generator | None = None) -> None:
    """Normal weights of std 1/√fan_in and zero bias (flax Dense's default
    up to the truncation of its normal)."""
    with torch.no_grad():
        layer.weight.copy_(
            torch.randn(layer.weight.shape, generator=generator) / math.sqrt(layer.in_features)
        )
        layer.bias.zero_()


class Actor(nn.Module):
    """Deterministic policy µ(s): encoder → Dense → tanh, actions in [-1, 1]².

    ``obs_shape``: per-env observation shape, e.g. ``config.obs_shape``.
    Parameters are float32, drawn on the CPU from ``generator`` (the global
    RNG when None) and moved to ``device`` (default CUDA).  The encoder
    computes in bfloat16, the head in float32.
    """

    def __init__(self, obs_shape: Sequence[int], action_dim: int = 2,
                 use_raw_pixels: bool = False, pixel_pool: int = 1,
                 height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = ObsEncoder(math.prod(obs_shape), use_raw_pixels, hidden,
                                  pixel_pool=pixel_pool, height=height, width=width)
        self.mu = nn.Linear(hidden[-1], action_dim)
        for m in self.encoder.modules():
            if isinstance(m, nn.Linear):
                lecun_init(m, generator)
        final_layer_init(self.mu, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.mu(self.encoder(obs)))


class Critic(nn.Module):
    """Q(s, a): encoder → concat(action) → one hidden layer of
    ``hidden[-1]`` → Dense → scalar, the action injected after the state
    trunk as in the DDPG paper.

    Parameters as for :class:`Actor`.  The encoder and the late hidden
    layer compute in bfloat16 (the action is cast with the features), the
    head in float32.
    """

    def __init__(self, obs_shape: Sequence[int], action_dim: int = 2,
                 use_raw_pixels: bool = False, pixel_pool: int = 1,
                 height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = ObsEncoder(math.prod(obs_shape), use_raw_pixels, hidden,
                                  pixel_pool=pixel_pool, height=height, width=width)
        self.head = MLPTrunk(hidden[-1] + action_dim, (hidden[-1],))
        self.q = nn.Linear(hidden[-1], 1)
        for m in (*self.encoder.modules(), *self.head.modules()):
            if isinstance(m, nn.Linear):
                lecun_init(m, generator)
        final_layer_init(self.q, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        h = self.encoder(obs)
        h = self.head(torch.cat([h, action.to(h.dtype)], dim=-1))
        return self.q(h)[..., 0]


class TwinCritic(nn.Module):
    """TD3's clipped double-Q pair: two independently initialised critics
    (the JAX package stacks their params on a leading axis of 2 and vmaps
    one critic).  ``forward`` → (2, B); ``q1`` → the first critic's Q."""

    def __init__(self, *args, generator: torch.Generator | None = None, **kwargs):
        super().__init__()
        self.critics = nn.ModuleList(
            Critic(*args, generator=generator, **kwargs) for _ in range(2))

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return torch.stack([c(obs, action) for c in self.critics])

    def q1(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self.critics[0](obs, action)

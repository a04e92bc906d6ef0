"""Agent networks: port of the DDPG ``Actor`` and ``Critic`` of
cartpoleplusplus_tpu.models.networks, the TD3 twin critic, SAC's and PPO's
``GaussianActor``, PPO's ``ValueNetwork`` and LRPG's ``DiscretePolicy``."""

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


def lecun_init(layer: nn.Linear | nn.Conv2d, generator: torch.Generator | None = None) -> None:
    """Normal weights of std 1/√fan_in and zero bias (flax Dense's and
    Conv's default up to the truncation of its normal)."""
    fan_in = math.prod(layer.weight.shape[1:])
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator) / math.sqrt(fan_in))
        layer.bias.zero_()


def _init_hidden(modules, generator: torch.Generator | None) -> None:
    for m in modules:
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_init(m, generator)


def _encoder(obs_shape: Sequence[int], use_raw_pixels: bool, hidden: Sequence[int],
             pixel_pool: int, height: int, width: int, pixel_encoder: str) -> ObsEncoder:
    return ObsEncoder(math.prod(obs_shape), use_raw_pixels, hidden, pixel_pool=pixel_pool,
                      height=height, width=width, pixel_encoder=pixel_encoder)


class Actor(nn.Module):
    """Deterministic policy µ(s): encoder → Dense → tanh, actions in [-1, 1]².

    ``obs_shape``: per-env observation shape, e.g. ``config.obs_shape``;
    ``pixel_encoder``: "dense" or "conv" (:class:`ObsEncoder`).
    Parameters are float32, drawn on the CPU from ``generator`` (the global
    RNG when None) and moved to ``device`` (default CUDA).  The encoder
    computes in bfloat16, the head in float32.
    """

    def __init__(self, obs_shape: Sequence[int], action_dim: int = 2,
                 use_raw_pixels: bool = False, pixel_pool: int = 1,
                 height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None, pixel_encoder: str = "dense"):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = _encoder(obs_shape, use_raw_pixels, hidden, pixel_pool, height, width,
                                pixel_encoder)
        self.mu = nn.Linear(hidden[-1], action_dim)
        _init_hidden(self.encoder.modules(), generator)
        final_layer_init(self.mu, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.mu(self.encoder(obs)))


class GaussianActor(nn.Module):
    """SAC's tanh-squashed Gaussian policy π(a|s): the :class:`Actor`'s
    encoder, then two heads, the pre-squash mean ``mu`` and ``log_std``
    clamped to [``log_std_min``, ``log_std_max``]; ``forward`` → (mu,
    log_std).  Sampling and the log-prob live in ``agents/sac.py``.

    Parameters as for :class:`Actor`; both heads take the final-layer init.
    The encoder computes in bfloat16, the heads in float32.
    """

    def __init__(self, obs_shape: Sequence[int], action_dim: int = 2,
                 use_raw_pixels: bool = False, pixel_pool: int = 1,
                 height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None, pixel_encoder: str = "dense",
                 log_std_min: float = -20.0, log_std_max: float = 2.0):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = _encoder(obs_shape, use_raw_pixels, hidden, pixel_pool, height, width,
                                pixel_encoder)
        self.mu = nn.Linear(hidden[-1], action_dim)
        self.log_std = nn.Linear(hidden[-1], action_dim)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        _init_hidden(self.encoder.modules(), generator)
        final_layer_init(self.mu, generator)
        final_layer_init(self.log_std, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.encoder(obs)
        return self.mu(h), torch.clamp(self.log_std(h), self.log_std_min, self.log_std_max)


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
                 generator: torch.Generator | None = None, pixel_encoder: str = "dense"):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = _encoder(obs_shape, use_raw_pixels, hidden, pixel_pool, height, width,
                                pixel_encoder)
        self.head = MLPTrunk(hidden[-1] + action_dim, (hidden[-1],))
        self.q = nn.Linear(hidden[-1], 1)
        _init_hidden((*self.encoder.modules(), *self.head.modules()), generator)
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


class ValueNetwork(nn.Module):
    """PPO's state value V(s): the :class:`Actor`'s encoder, then one head
    ``v`` with the final-layer init; ``forward`` → (B,).

    Parameters as for :class:`Actor`.  The encoder computes in bfloat16,
    the head in float32.
    """

    def __init__(self, obs_shape: Sequence[int], use_raw_pixels: bool = False,
                 pixel_pool: int = 1, height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None, pixel_encoder: str = "dense"):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = _encoder(obs_shape, use_raw_pixels, hidden, pixel_pool, height, width,
                                pixel_encoder)
        self.v = nn.Linear(hidden[-1], 1)
        _init_hidden(self.encoder.modules(), generator)
        final_layer_init(self.v, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.v(self.encoder(obs))[..., 0]


class DiscretePolicy(nn.Module):
    """LRPG's softmax policy over the discrete actions: the :class:`Actor`'s
    encoder, then a head ``logits`` of ``num_actions`` outputs; ``forward``
    → logits (B, num_actions).

    Parameters as for :class:`Actor`, but the head takes the hidden layers'
    init (a plain flax ``Dense``: LeCun normal, zero bias), not the
    final-layer one.  The encoder computes in bfloat16, the head in float32.
    """

    def __init__(self, obs_shape: Sequence[int], num_actions: int = 5,
                 use_raw_pixels: bool = False, pixel_pool: int = 1,
                 height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None, pixel_encoder: str = "dense"):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = _encoder(obs_shape, use_raw_pixels, hidden, pixel_pool, height, width,
                                pixel_encoder)
        self.logits = nn.Linear(hidden[-1], num_actions)
        _init_hidden((*self.encoder.modules(), self.logits), generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.logits(self.encoder(obs))

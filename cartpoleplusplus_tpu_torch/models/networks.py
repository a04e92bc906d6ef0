"""Agent networks: port of the DDPG ``Actor`` and ``Critic`` of
cartpoleplusplus_tpu.models.networks, the TD3 twin critic, SAC's and PPO's
``GaussianActor``, PPO's ``ValueNetwork``, LRPG's ``DiscretePolicy``,
DQN's ``QNetwork`` with its NoisyNet layer ``NoisyLinear``, and NAF's
``NAFNetwork``.

``Actor``, ``Critic``, ``TwinCritic`` and ``NAFNetwork`` take
``use_batch_norm`` and a ``train`` argument in ``forward`` (default False),
as the flax modules do: with batch norm, ``train=True`` normalises by the
batch and moves the running statistics, ``train=False`` reads them."""

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
             pixel_pool: int, height: int, width: int, pixel_encoder: str,
             use_batch_norm: bool = False) -> ObsEncoder:
    return ObsEncoder(math.prod(obs_shape), use_raw_pixels, hidden, pixel_pool=pixel_pool,
                      height=height, width=width, pixel_encoder=pixel_encoder,
                      use_batch_norm=use_batch_norm)


class Actor(nn.Module):
    """Deterministic policy µ(s): encoder → Dense → tanh, actions in [-1, 1]².

    ``obs_shape``: per-env observation shape, e.g. ``config.obs_shape``;
    ``pixel_encoder``: "dense" or "conv" (:class:`ObsEncoder`);
    ``use_batch_norm``: batch norm of the encoder's features.
    Parameters are float32, drawn on the CPU from ``generator`` (the global
    RNG when None) and moved to ``device`` (default CUDA).  The encoder
    computes in bfloat16, the head in float32.
    """

    def __init__(self, obs_shape: Sequence[int], action_dim: int = 2,
                 use_raw_pixels: bool = False, pixel_pool: int = 1,
                 height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None, pixel_encoder: str = "dense",
                 use_batch_norm: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = _encoder(obs_shape, use_raw_pixels, hidden, pixel_pool, height, width,
                                pixel_encoder, use_batch_norm)
        self.mu = nn.Linear(hidden[-1], action_dim)
        _init_hidden(self.encoder.modules(), generator)
        final_layer_init(self.mu, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.tanh(self.mu(self.encoder(obs, train)))


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

    Parameters and ``use_batch_norm`` as for :class:`Actor`.  The encoder
    and the late hidden layer compute in bfloat16 (the action is cast with
    the features), the head in float32.
    """

    def __init__(self, obs_shape: Sequence[int], action_dim: int = 2,
                 use_raw_pixels: bool = False, pixel_pool: int = 1,
                 height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None, pixel_encoder: str = "dense",
                 use_batch_norm: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = _encoder(obs_shape, use_raw_pixels, hidden, pixel_pool, height, width,
                                pixel_encoder, use_batch_norm)
        self.head = MLPTrunk(hidden[-1] + action_dim, (hidden[-1],))
        self.q = nn.Linear(hidden[-1], 1)
        _init_hidden((*self.encoder.modules(), *self.head.modules()), generator)
        final_layer_init(self.q, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor, action: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        h = self.encoder(obs, train)
        h = self.head(torch.cat([h, action.to(h.dtype)], dim=-1))
        return self.q(h)[..., 0]


class TwinCritic(nn.Module):
    """TD3's clipped double-Q pair: two independently initialised critics
    (the JAX package stacks their params on a leading axis of 2 and vmaps
    one critic, its batch statistics stacked the same way).  ``forward`` →
    (2, B); ``q1`` → the first critic's Q."""

    def __init__(self, *args, generator: torch.Generator | None = None, **kwargs):
        super().__init__()
        self.critics = nn.ModuleList(
            Critic(*args, generator=generator, **kwargs) for _ in range(2))

    def forward(self, obs: torch.Tensor, action: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        return torch.stack([c(obs, action, train) for c in self.critics])

    def q1(self, obs: torch.Tensor, action: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.critics[0](obs, action, train)


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


def _scaled_noise(e: torch.Tensor) -> torch.Tensor:
    """NoisyNet's f(e) = sign(e)·√|e|."""
    return torch.sign(e) * torch.sqrt(torch.abs(e))


class NoisyLinear(nn.Module):
    """Factorized-Gaussian noisy linear layer (Fortunato et al. 2018), the
    port of flax ``NoisyDense``: ``weight``/``bias`` (flax's
    ``kernel``/``bias``, the mu weights) and ``weight_sigma``/``bias_sigma``.

    Init: the mu weights and bias uniform in ±1/√in (from ``generator``,
    the global RNG when None), both sigmas the constant ``sigma0``/√in.
    ``forward(x, noise=None)``: the mu weights alone, or with ``noise`` =
    ``(eps_in, eps_out)``, standard normals of shapes (in,) and (out,), ``W
    = W_mu + W_sigma ⊙ f(e_out) f(e_in)ᵀ`` and ``b = b_mu + b_sigma ⊙
    f(e_out)``: one draw per forward, shared by every row of the batch, as
    in JAX.  Computes in float32.
    """

    def __init__(self, in_features: int, out_features: int, sigma0: float = 0.5,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        bound = 1.0 / math.sqrt(in_features)
        uniform = lambda *shape: (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
        self.weight = nn.Parameter(uniform(out_features, in_features))
        self.bias = nn.Parameter(uniform(out_features))
        sig0 = sigma0 / math.sqrt(in_features)
        self.weight_sigma = nn.Parameter(torch.full((out_features, in_features), sig0))
        self.bias_sigma = nn.Parameter(torch.full((out_features,), sig0))

    def draw(self, generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """One ``(eps_in, eps_out)`` from ``generator``, on the layer's
        device, in flax's order (in, then out)."""
        dev = self.weight.device
        return (torch.randn((self.in_features,), generator=generator, device=dev),
                torch.randn((self.out_features,), generator=generator, device=dev))

    def forward(self, x: torch.Tensor, noise=None) -> torch.Tensor:
        if noise is None:
            return x @ self.weight.t() + self.bias
        e_in, e_out = (_scaled_noise(e.to(self.weight.device)) for e in noise)
        w = self.weight + self.weight_sigma * (e_out[:, None] * e_in[None, :])
        return x @ w.t() + (self.bias + self.bias_sigma * e_out)


class QNetwork(nn.Module):
    """DQN's per-action values over the :class:`Actor`'s encoder, the port of
    flax ``QNetwork``; ``forward`` → (B, num_actions), or under C51
    (``num_atoms`` > 0) the atom logits (B, num_actions, num_atoms).

    Heads, by their flax names: plain ``q``; ``dueling`` a ``value`` (1)
    and an ``advantage`` (A) head, ``v + a − mean_a(a)``; C51 an
    ``advantage`` head of A·K logits (so named with or without dueling),
    with ``dueling`` a ``value`` head of K logits, the mean over actions
    taken per atom in logit space.  ``noisy`` makes every head a
    :class:`NoisyLinear`; plain heads take flax ``Dense``'s init (LeCun
    normal, zero bias).  Parameters otherwise as for :class:`Actor`; the
    encoder computes in bfloat16, the heads in float32.

    ``forward(obs, noise=None, generator=None)``: without either the noisy
    heads run their mu weights (greedy acting); with ``noise`` (``{head
    name: (eps_in, eps_out)}``) or ``generator`` they run noisy, each head
    not in ``noise`` drawing its own from ``generator``.  The heads run (and
    draw) in JAX's order, :attr:`head_order`.
    """

    def __init__(self, obs_shape: Sequence[int], num_actions: int = 5, dueling: bool = False,
                 num_atoms: int = 0, noisy: bool = False, use_raw_pixels: bool = False,
                 pixel_pool: int = 1, height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None, pixel_encoder: str = "dense"):
        super().__init__()
        dev = resolve_device(device)
        self.num_actions, self.dueling, self.num_atoms = num_actions, dueling, num_atoms
        self.noisy = noisy
        self.encoder = _encoder(obs_shape, use_raw_pixels, hidden, pixel_pool, height, width,
                                pixel_encoder)
        _init_hidden(self.encoder.modules(), generator)
        k = max(num_atoms, 1)
        if num_atoms:
            widths = {"advantage": num_actions * k, **({"value": k} if dueling else {})}
        elif dueling:
            widths = {"value": 1, "advantage": num_actions}
        else:
            widths = {"q": num_actions}
        self.head_order = tuple(widths)
        for name, out in widths.items():
            if noisy:
                head = NoisyLinear(hidden[-1], out, generator=generator)
            else:
                head = nn.Linear(hidden[-1], out)
                lecun_init(head, generator)
            self.add_module(name, head)
        self.to(dev)

    def _head(self, name: str, h: torch.Tensor, noise, generator) -> torch.Tensor:
        head = getattr(self, name)
        if not self.noisy or (noise is None and generator is None):
            return head(h)
        eps = (noise or {}).get(name)
        return head(h, eps if eps is not None else head.draw(generator))

    def forward(self, obs: torch.Tensor, noise: dict | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.encoder(obs)
        out = {name: self._head(name, h, noise, generator) for name in self.head_order}
        if self.num_atoms:
            a = out["advantage"].reshape(h.shape[0], self.num_actions, self.num_atoms)
            if self.dueling:
                return out["value"][:, None, :] + a - a.mean(dim=-2, keepdim=True)
            return a
        if self.dueling:
            a = out["advantage"]
            return out["value"] + a - a.mean(dim=-1, keepdim=True)
        return out["q"]


class NAFNetwork(nn.Module):
    """Normalized Advantage Function heads over the :class:`Actor`'s encoder,
    the port of flax ``NAFNetwork``: ``value`` (V(s), → (B,)), ``mu`` (tanh,
    → (B, action_dim)) and ``l_entries`` (the n(n+1)/2 entries of the lower
    triangle of L(s)), each with the final-layer init; ``forward(obs,
    train=False)`` → (v, mu, l_entries).  ``A(s, a) = −½‖Lᵀ(a − µ)‖²`` and
    ``Q = V + A`` are the static :meth:`advantage` and :meth:`q_value`.

    Parameters and ``use_batch_norm`` as for :class:`Actor`.  The encoder
    computes in bfloat16, the heads in float32.
    """

    # Bounds of L's log-diagonal (exp(d) in [e⁻⁵, e²]), the JAX class's.
    LOG_DIAG_MIN = -5.0
    LOG_DIAG_MAX = 2.0

    def __init__(self, obs_shape: Sequence[int], action_dim: int = 2,
                 use_raw_pixels: bool = False, pixel_pool: int = 1,
                 height: int = 50, width: int = 50,
                 hidden: Sequence[int] = DEFAULT_HIDDEN, device=None,
                 generator: torch.Generator | None = None, pixel_encoder: str = "dense",
                 use_batch_norm: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.encoder = _encoder(obs_shape, use_raw_pixels, hidden, pixel_pool, height, width,
                                pixel_encoder, use_batch_norm)
        self.value = nn.Linear(hidden[-1], 1)
        self.mu = nn.Linear(hidden[-1], action_dim)
        self.l_entries = nn.Linear(hidden[-1], action_dim * (action_dim + 1) // 2)
        _init_hidden(self.encoder.modules(), generator)
        for head in (self.value, self.mu, self.l_entries):
            final_layer_init(head, generator)
        self.to(dev)

    def forward(self, obs: torch.Tensor, train: bool = False):
        h = self.encoder(obs, train)
        return self.value(h)[..., 0], torch.tanh(self.mu(h)), self.l_entries(h)

    @staticmethod
    def lower_triangular(l_flat: torch.Tensor, action_dim: int) -> torch.Tensor:
        """(…, n(n+1)/2) entries → L (…, n, n): filled row by row in
        ``tril_indices`` order, the diagonal clamped to [LOG_DIAG_MIN,
        LOG_DIAG_MAX] and exponentiated, in the JAX version's operations."""
        rows, cols = torch.tril_indices(action_dim, action_dim, device=l_flat.device)
        L = torch.zeros(l_flat.shape[:-1] + (action_dim, action_dim), dtype=l_flat.dtype,
                        device=l_flat.device)
        L[..., rows, cols] = l_flat
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        d = torch.clamp(diag, NAFNetwork.LOG_DIAG_MIN, NAFNetwork.LOG_DIAG_MAX)
        eye = torch.eye(action_dim, dtype=l_flat.dtype, device=l_flat.device)
        return (L - eye * diag[..., None, :]) + eye * torch.exp(d)[..., None, :]

    @staticmethod
    def advantage(l_flat: torch.Tensor, mu: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """A(s, a) = −½ (a − µ)ᵀ L Lᵀ (a − µ)."""
        L = NAFNetwork.lower_triangular(l_flat, mu.shape[-1])
        ld = L.transpose(-1, -2) @ (action - mu)[..., None]
        return -0.5 * torch.sum(ld[..., 0] ** 2, dim=-1)

    @staticmethod
    def q_value(v: torch.Tensor, l_flat: torch.Tensor, mu: torch.Tensor,
                action: torch.Tensor) -> torch.Tensor:
        return v + NAFNetwork.advantage(l_flat, mu, action)

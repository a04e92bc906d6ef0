"""On-device replay memory: port of cartpoleplusplus_tpu.replay.buffer.

A fixed-capacity circular buffer of (s1, a, r, s2, terminal) in device
tensors, written in place.  The cursor and fill level are host ints: every
write is a batch of known size, so they never need a device read, and the
train gate that tests them stays on the host.

Two storage modes, as in the JAX package:

* ``block == 0`` (general): both observations of every transition are
  stored.
* ``block > 0`` (s2-free): only s1 is stored and ``s2(i)`` is row
  ``(i + block) % capacity``, the same env slot's observation one
  vectorized step later, because the fused loop writes exactly one
  ``block``-sized batch (all envs) per step.  For a terminal transition
  that row is the reset observation, which the TD target masks out; the
  newest block has no successor yet, so :func:`sample` never draws it.

Two extensions, as in the JAX package: proportional prioritized sampling
(:func:`sample_prioritized`, :func:`update_priorities`; a ``priority`` row
that :func:`add_batch` stamps with the running max) and n-step returns on
the s2-free layout (:func:`nstep_batch`: transition i's k-th successor for
the same env slot is row ``(i + k·block) % capacity``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ReplayState:
    """Buffer contents (device tensors) and the host-side cursor and size."""

    s1: torch.Tensor        # (capacity, *obs_shape)
    action: torch.Tensor    # (capacity, *action_shape)
    reward: torch.Tensor    # (capacity,) float32
    s2: torch.Tensor        # (capacity, *obs_shape), or (0,) when block > 0
    terminal: torch.Tensor  # (capacity,) bool
    # (capacity,) float32 sampling priorities when prioritized, else (0,);
    # a fresh buffer's are ones.
    priority: torch.Tensor
    cursor: int = 0         # next write slot
    size: int = 0           # valid entries
    block: int = 0          # 0 = explicit s2; > 0 = s2-free insertion block

    @property
    def capacity(self) -> int:
        return self.s1.shape[0]

    @property
    def prioritized(self) -> bool:
        return self.priority.shape[0] > 0


def create(
    capacity: int,
    obs_shape: tuple[int, ...],
    action_shape: tuple[int, ...],
    obs_dtype=torch.float32,
    action_dtype=torch.float32,
    block: int = 0,
    device=None,
    prioritized: bool = False,
) -> ReplayState:
    """Preallocate the buffer.  ``block > 0`` selects s2-free storage; it
    must equal the batch of every later :func:`add_batch` and divide
    ``capacity`` into at least two blocks, so every write is one contiguous
    slice.  (The JAX package trims such a capacity down to a multiple of
    the block; here the caller chooses one.)  ``prioritized`` allocates the
    per-slot priorities, initialised to ones."""
    if block < 0 or block >= capacity:
        raise ValueError(f"block {block} must be in [0, capacity={capacity})")
    if block and capacity % block:
        raise ValueError(f"capacity {capacity} must be a multiple of the insertion block {block}")
    s2_shape = (0,) if block else (capacity, *obs_shape)
    return ReplayState(
        s1=torch.zeros((capacity, *obs_shape), dtype=obs_dtype, device=device),
        action=torch.zeros((capacity, *action_shape), dtype=action_dtype, device=device),
        reward=torch.zeros((capacity,), dtype=torch.float32, device=device),
        s2=torch.zeros(s2_shape, dtype=obs_dtype, device=device),
        terminal=torch.zeros((capacity,), dtype=torch.bool, device=device),
        priority=torch.ones((capacity if prioritized else 0,), dtype=torch.float32,
                            device=device),
        block=block,
    )


def add_batch(
    replay: ReplayState,
    s1: torch.Tensor,
    action: torch.Tensor,
    reward: torch.Tensor,
    s2: Optional[torch.Tensor],
    terminal: torch.Tensor,
) -> ReplayState:
    """Write B transitions at the cursor with wraparound, in place.  In
    s2-free mode ``s2`` is ignored and B must be ``block``.  A prioritized
    buffer stamps the new rows with ``max(max(priority), 1)``, so each is
    replayed before a measured TD error corrects it."""
    b = s1.shape[0]
    if replay.block and b != replay.block:
        raise ValueError(f"s2-free replay requires fixed batch {replay.block}, got {b}")
    cap = replay.capacity
    fields = [(replay.s1, s1), (replay.action, action), (replay.reward, reward),
              (replay.terminal, terminal)]
    if replay.prioritized:
        pmax = torch.clamp(replay.priority.max(), min=1.0)
        fields.append((replay.priority, pmax.expand(b)))
    if replay.block:
        # The cursor is a multiple of the block: one contiguous slice each.
        for buf, val in fields:
            buf[replay.cursor : replay.cursor + b] = val
    else:
        idx = (replay.cursor + torch.arange(b, device=replay.s1.device)) % cap
        for buf, val in fields + [(replay.s2, s2)]:
            buf[idx] = val.to(buf.dtype)
    replay.cursor = (replay.cursor + b) % cap
    replay.size = min(replay.size + b, cap)
    return replay


def encode_obs(obs: torch.Tensor, storage_dtype) -> torch.Tensor:
    """Quantize [0, 1] float observations for storage (uint8 frames from
    the renderer pass through)."""
    if storage_dtype == torch.uint8:
        if obs.dtype == torch.uint8:
            return obs
        return torch.clamp(obs * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return obs.to(storage_dtype)


def decode_obs(stored: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_obs`: float32, in [0, 1] for uint8."""
    if stored.dtype == torch.uint8:
        return stored.to(torch.float32) * (1.0 / 255.0)
    return stored.to(torch.float32)


def _valid_count(replay: ReplayState, n_step: int = 1) -> int:
    """The number of rows :func:`sample` may draw: in s2-free mode all but
    the newest ``n_step`` blocks (their successors are not written yet), at
    least 1; otherwise the ``size`` written rows, at least 1."""
    if replay.block:
        return max(replay.size - n_step * replay.block, 1)
    return max(replay.size, 1)


def _start(replay: ReplayState) -> int:
    """The oldest row of an s2-free ring: slot 0 until it is full, the
    cursor after."""
    return 0 if replay.size < replay.capacity else replay.cursor


def sample_offsets(replay: ReplayState, batch_size: int,
                   generator: Optional[torch.Generator] = None, n_step: int = 1) -> torch.Tensor:
    """Uniform draws in [0, the number of sampleable rows) for
    :func:`sample`: the ``size - n_step·block`` older rows in s2-free mode
    (at least 1), the ``size`` written rows otherwise."""
    return torch.randint(0, _valid_count(replay, n_step), (batch_size,), generator=generator,
                         device=replay.s1.device)


def sample(replay: ReplayState, batch_size: int,
           generator: Optional[torch.Generator] = None,
           offsets: Optional[torch.Tensor] = None, n_step: int = 1, gamma: float = 0.99):
    """Uniform batch → ``(s1, action, reward, s2, terminal)``.

    ``offsets``: pre-drawn draws of :func:`sample_offsets`.  In s2-free
    mode they count from the oldest row (slot 0 until the ring is full,
    the cursor after) and s2 is gathered one block later.  ``n_step > 1``
    (s2-free mode only) returns :func:`nstep_batch`'s n-step rewards and
    any-terminal flags; callers bootstrap with ``gamma ** n_step``.
    """
    if offsets is None:
        offsets = sample_offsets(replay, batch_size, generator, n_step)
    if replay.block:
        idx = (_start(replay) + offsets) % replay.capacity
        if n_step > 1:
            return nstep_batch(replay, idx, n_step, gamma)
        s2 = replay.s1[(idx + replay.block) % replay.capacity]
    else:
        if n_step > 1:
            raise ValueError("n-step sampling requires s2-free block mode")
        idx = offsets
        s2 = replay.s2[idx]
    return replay.s1[idx], replay.action[idx], replay.reward[idx], s2, replay.terminal[idx]


def valid_mask(replay: ReplayState, n_step: int = 1) -> tuple[torch.Tensor, int]:
    """(mask (capacity,) bool, count) of the slots :func:`sample` may draw,
    by its index arithmetic (the JAX ``_valid_mask``)."""
    cap = replay.capacity
    pos = torch.arange(cap, device=replay.s1.device)
    valid = _valid_count(replay, n_step)
    if replay.block:
        return (pos - _start(replay)) % cap < valid, valid
    return pos < valid, valid


def nstep_batch(replay: ReplayState, idx: torch.Tensor, n_step: int, gamma: float):
    """The n-step transitions at rows ``idx`` of an s2-free buffer →
    ``(s1, action, r_n, s2_n, done_n)``:

        r_n(i)    = Σ_{k<n} γ^k · r(i + k·block) · Π_{j<k} alive(i + j·block)
        done_n(i) = any terminal inside the window
        s2_n(i)   = s1 row (i + n·block)

    Rewards past the first terminal belong to the env slot's next episode
    and are masked by the alive product, as in the JAX package.
    """
    if not replay.block:
        raise ValueError("n-step sampling requires s2-free block mode")
    cap = replay.capacity
    r_n = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    alive = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    for k in range(n_step):
        j = (idx + k * replay.block) % cap
        r_n = r_n + (gamma ** k) * alive * replay.reward[j]
        alive = alive * (1.0 - replay.terminal[j].to(torch.float32))
    s2 = replay.s1[(idx + n_step * replay.block) % cap]
    return replay.s1[idx], replay.action[idx], r_n, s2, alive < 0.5


def sample_prioritized(replay: ReplayState, batch_size: int, alpha: float, beta: float,
                       n_step: int = 1, gamma: float = 0.99,
                       generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None):
    """Proportional prioritized batch (Schaul et al. 2016) →
    ``(batch, idx, iw)``.

    The JAX package's sampler, op for op: priorities raised to ``alpha``
    and masked to the sampleable window after the power (so ``alpha`` 0
    cannot revive an invalid slot), one cumsum for the CDF, and
    ``searchsorted(right=True)`` of ``u·(1 − ε)·total`` for all draws at
    once (the shrink keeps a draw below the total after float32
    rounding).  ``iw`` = ``(N·P(i))^−beta`` normalised to a batch max of 1.
    ``u``: pre-drawn uniforms in [0, 1) of shape (batch_size,), drawn from
    ``generator`` when not given.
    """
    mask, count = valid_mask(replay, n_step)
    w = torch.where(mask, replay.priority ** alpha, 0.0)
    cdf = torch.cumsum(w, dim=0)
    total = cdf[-1]
    if u is None:
        u = torch.rand((batch_size,), generator=generator, device=cdf.device)
    u = (u.to(cdf.device) * (1.0 - torch.finfo(torch.float32).eps)) * total
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, replay.capacity - 1)
    p = w[idx] / torch.clamp(total, min=1e-12)
    iw = (float(count) * torch.clamp(p, min=1e-12)) ** (-beta)
    iw = iw / torch.clamp(iw.max(), min=1e-12)
    if n_step > 1:
        return nstep_batch(replay, idx, n_step, gamma), idx, iw
    if replay.block:
        s2 = replay.s1[(idx + replay.block) % replay.capacity]
    else:
        s2 = replay.s2[idx]
    batch = (replay.s1[idx], replay.action[idx], replay.reward[idx], s2, replay.terminal[idx])
    return batch, idx, iw


def update_priorities(replay: ReplayState, idx: torch.Tensor, td_abs: torch.Tensor,
                      eps: float = 1e-2, gate=None) -> ReplayState:
    """Write ``|TD| + eps`` back as the sampled rows' priorities, in place.
    ``gate`` (a bool or a 0-d bool tensor): where False the rows keep their
    priorities, the JAX convention before the train gate opens."""
    new_p = td_abs + eps
    if gate is not None:
        new_p = torch.where(torch.as_tensor(gate, device=new_p.device), new_p,
                            replay.priority[idx])
    replay.priority[idx] = new_p
    return replay

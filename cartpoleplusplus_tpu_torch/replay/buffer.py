"""On-device replay memory: port of the uniform path of
cartpoleplusplus_tpu.replay.buffer.

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

Prioritized replay and n-step returns are not ported yet.
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
    cursor: int = 0         # next write slot
    size: int = 0           # valid entries
    block: int = 0          # 0 = explicit s2; > 0 = s2-free insertion block

    @property
    def capacity(self) -> int:
        return self.s1.shape[0]


def create(
    capacity: int,
    obs_shape: tuple[int, ...],
    action_shape: tuple[int, ...],
    obs_dtype=torch.float32,
    action_dtype=torch.float32,
    block: int = 0,
    device=None,
) -> ReplayState:
    """Preallocate the buffer.  ``block > 0`` selects s2-free storage; it
    must equal the batch of every later :func:`add_batch` and divide
    ``capacity`` into at least two blocks, so every write is one contiguous
    slice.  (The JAX package trims such a capacity down to a multiple of
    the block; here the caller chooses one.)"""
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
    s2-free mode ``s2`` is ignored and B must be ``block``."""
    b = s1.shape[0]
    if replay.block and b != replay.block:
        raise ValueError(f"s2-free replay requires fixed batch {replay.block}, got {b}")
    cap = replay.capacity
    fields = [(replay.s1, s1), (replay.action, action), (replay.reward, reward),
              (replay.terminal, terminal)]
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


def sample_offsets(replay: ReplayState, batch_size: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform draws in [0, the number of sampleable rows) for
    :func:`sample`: the ``size - block`` older rows in s2-free mode (at
    least 1), the ``size`` written rows otherwise."""
    valid = max(replay.size - replay.block, 1)
    return torch.randint(0, valid, (batch_size,), generator=generator,
                         device=replay.s1.device)


def sample(replay: ReplayState, batch_size: int,
           generator: Optional[torch.Generator] = None,
           offsets: Optional[torch.Tensor] = None):
    """Uniform batch → ``(s1, action, reward, s2, terminal)``.

    ``offsets``: pre-drawn draws of :func:`sample_offsets`.  In s2-free
    mode they count from the oldest row (slot 0 until the ring is full,
    the cursor after) and s2 is gathered one block later.
    """
    if offsets is None:
        offsets = sample_offsets(replay, batch_size, generator)
    if replay.block:
        start = 0 if replay.size < replay.capacity else replay.cursor
        idx = (start + offsets) % replay.capacity
        s2 = replay.s1[(idx + replay.block) % replay.capacity]
    else:
        idx = offsets
        s2 = replay.s2[idx]
    return replay.s1[idx], replay.action[idx], replay.reward[idx], s2, replay.terminal[idx]

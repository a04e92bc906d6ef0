"""Quaternion helpers (``(w, x, y, z)``, scalar first) on torch tensors.

The subset of cartpoleplusplus_tpu.physics.math3d that the batched env
uses: the reset's pole jitter and the angle reward.  Shape-polymorphic over
leading batch dims.
"""

from __future__ import annotations

import torch

# Normalisation guard in float32.
_EPS = 1e-8


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis (..., 3, need not be normalised) + angle (...,) → quaternion."""
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=_EPS)
    half = 0.5 * angle
    w = torch.cos(half)[..., None]
    xyz = axis * torch.sin(half)[..., None]
    return torch.cat([w, xyz], dim=-1)


def quat_tilt_angle(q: torch.Tensor) -> torch.Tensor:
    """Angle (rad) between the body z-axis and world +z."""
    x, y = q[..., 1], q[..., 2]
    cos_tilt = 1.0 - 2.0 * (x * x + y * y)
    return torch.arccos(torch.clamp(cos_tilt, -1.0, 1.0))

"""Quaternion / rigid-transform math (``(w, x, y, z)``, scalar first) on
torch tensors.

Port of cartpoleplusplus_tpu.physics.math3d.  Shape-polymorphic over
leading batch dims; every expression keeps the JAX version's order term by
term, which is what keeps float32 contact decisions of the AoS engine
(engine.py) together with the JAX one.
"""

from __future__ import annotations

import torch

# Normalisation guard in float32.
_EPS = 1e-8


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` along the last axis, broadcasting, its terms in order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm along the last axis, kept: ``sqrt(Σ x²)``."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalise quaternion(s) to unit length along the last axis."""
    return q / torch.clamp(norm(q), min=_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, both (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by unit quaternion(s) q (..., 4):
    ``v + 2 (w (u × v) + u × (u × v))``."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of unit quaternion q (world → body frame)."""
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) (..., 4) → rotation matrices (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis (..., 3, need not be normalised) + angle (...,) → quaternion."""
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=_EPS)
    half = 0.5 * angle
    w = torch.cos(half)[..., None]
    xyz = axis * torch.sin(half)[..., None]
    return torch.cat([w, xyz], dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation: q ← normalize(q + dt/2 · (0, ω) ⊗ q)."""
    omega_q = torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1)
    dq = quat_mul(omega_q, q)
    return quat_normalize(q + (0.5 * float(dt)) * dq)


def quat_tilt_angle(q: torch.Tensor) -> torch.Tensor:
    """Angle (rad) between the body z-axis and world +z."""
    x, y = q[..., 1], q[..., 2]
    cos_tilt = 1.0 - 2.0 * (x * x + y * y)
    return torch.arccos(torch.clamp(cos_tilt, -1.0, 1.0))


def make_tangent_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two unit tangents orthogonal to unit normal(s) n (..., 3), branchless
    (Duff et al., 'Building an Orthonormal Basis, Revisited')."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    t2 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return t1, t2


def box_inertia(mass, half_extents: torch.Tensor) -> torch.Tensor:
    """Diagonal body-frame inertia of a solid box with given half extents
    (Bullet's ``btBoxShape::calculateLocalInertia``)."""
    hx, hy, hz = half_extents[..., 0], half_extents[..., 1], half_extents[..., 2]
    return (mass / 3.0) * torch.stack(
        [hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy], dim=-1
    )

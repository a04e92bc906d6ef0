"""Batched SoA physics in plain PyTorch: the plain version of kernels K1/K2.

A line-for-line port of cartpoleplusplus_tpu.physics.soa: state components
are (E,) rows, contact-slot quantities are (16, E) planes, and the 16-slot
manifold splits statically into 12 ground slots (0-3 cart corners, 4-11
pole corners, world-axis contact frame) and 4 pole-on-cart slots (12-15,
frame rotating with the cart), solved by mass-splitting Jacobi iterations.
The expression order follows the reference so the float32 results agree
with it to rounding; the CUDA kernel (csrc/physics.cu) repeats the same
arithmetic per env and is held against this module.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from cartpoleplusplus_tpu_torch.physics.bodies import RigidState, SceneParams

# Corner sign tables (contacts.py in the reference).
_BOTTOM4 = tuple(itertools.product((-1.0, 1.0), (-1.0, 1.0), (-1.0,)))
_ALL8 = tuple(itertools.product((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0)))
# Pole corners can penetrate the cart top at most this fraction of the
# cart's half-height before the slot deactivates.
TOP_FACE_BAND = 0.5
# Slack on the cart top face's x/y extent for pole-on-cart contacts.
TOP_FACE_MARGIN = 1e-3

_CART_CORNERS = np.asarray(_BOTTOM4, np.float32)  # (4, 3) signs
# Pole corners bottom-first, so slots 4-7 (the pole's bottom corners) are
# also the pole-on-cart corners of slots 12-15.
_POLE_CORNERS8 = np.asarray(_ALL8, np.float32)[[0, 2, 4, 6, 1, 3, 5, 7]]
N_SLOTS = 16


# ---------------------------------------------------------------------------
# Component-tuple vector/quaternion algebra: a "vec" is a tuple of 3 equal-
# shape tensors, a "quat" a tuple of 4 (w, x, y, z).
# ---------------------------------------------------------------------------


def v_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def q_normalize(q):
    inv = torch.rsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + 1e-12)
    return (q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv)


def q_integrate(q, omega, dt):
    """q ← normalize(q + dt/2 · (0, ω) ⊗ q)."""
    ow, ox, oy, oz = 0.0, omega[0], omega[1], omega[2]
    dw = ow * q[0] - ox * q[1] - oy * q[2] - oz * q[3]
    dx = ow * q[1] + ox * q[0] + oy * q[3] - oz * q[2]
    dy = ow * q[2] - ox * q[3] + oy * q[0] + oz * q[1]
    dz = ow * q[3] + ox * q[2] - oy * q[1] + oz * q[0]
    h = float(np.float32(0.5) * np.float32(dt))
    return q_normalize((q[0] + h * dw, q[1] + h * dx, q[2] + h * dy, q[3] + h * dz))


def q_to_mat(q):
    """Quat → 3×3 rotation as a tuple-of-tuples of tensors (row major)."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


def m_vec(m, v):
    """3×3 (tuple rows) times vec."""
    return (
        m[0][0] * v[0] + m[0][1] * v[1] + m[0][2] * v[2],
        m[1][0] * v[0] + m[1][1] * v[1] + m[1][2] * v[2],
        m[2][0] * v[0] + m[2][1] * v[1] + m[2][2] * v[2],
    )


def inv_inertia_world_mat(r, d):
    """R diag(d) Rᵀ from a rotation matrix; ``d`` three Python floats."""
    return tuple(
        tuple(
            r[i][0] * d[0] * r[j][0] + r[i][1] * d[1] * r[j][1] + r[i][2] * d[2] * r[j][2]
            for j in range(3)
        )
        for i in range(3)
    )


def tangent_basis(n):
    """Branchless Duff orthonormal basis for unit normals (component form)."""
    nx, ny, nz = n
    s = 2.0 * (nz >= 0.0).to(nx.dtype) - 1.0
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1 = (1.0 + s * nx * nx * a, s * b, -s * nx)
    t2 = (b, s + ny * ny * a, -ny)
    return t1, t2


class SoAState(NamedTuple):
    """Per-body component rows, each (E,)."""

    cart_pos: tuple
    cart_quat: tuple
    cart_vel: tuple
    cart_ang: tuple
    pole_pos: tuple
    pole_quat: tuple
    pole_vel: tuple
    pole_ang: tuple


# Row order of the packed (26, E) state the CUDA kernel reads and writes.
FIELDS = (
    ("cart_pos", 3), ("cart_quat", 4), ("cart_vel", 3), ("cart_ang", 3),
    ("pole_pos", 3), ("pole_quat", 4), ("pole_vel", 3), ("pole_ang", 3),
)
N_ROWS = sum(n for _, n in FIELDS)  # 26


def from_rigid(state: RigidState) -> SoAState:
    """(E, 2, k) AoS → component rows."""
    pick = lambda arr, b: tuple(arr[:, b, i] for i in range(arr.shape[-1]))
    return SoAState(
        cart_pos=pick(state.pos, 0), cart_quat=pick(state.quat, 0),
        cart_vel=pick(state.vel, 0), cart_ang=pick(state.ang, 0),
        pole_pos=pick(state.pos, 1), pole_quat=pick(state.quat, 1),
        pole_vel=pick(state.vel, 1), pole_ang=pick(state.ang, 1),
    )


def to_rigid(s: SoAState) -> RigidState:
    """Component rows → (E, 2, k) AoS."""
    stack2 = lambda a, b: torch.stack([torch.stack(a, -1), torch.stack(b, -1)], -2)
    return RigidState(
        pos=stack2(s.cart_pos, s.pole_pos),
        quat=stack2(s.cart_quat, s.pole_quat),
        vel=stack2(s.cart_vel, s.pole_vel),
        ang=stack2(s.cart_ang, s.pole_ang),
    )


def pack_state(state: RigidState) -> torch.Tensor:
    """RigidState (E, …) → contiguous (26, E) rows in FIELDS order."""
    s = from_rigid(state)
    return torch.stack([c for name, _ in FIELDS for c in getattr(s, name)])


def unpack_state(packed: torch.Tensor) -> RigidState:
    """(26, E) rows in FIELDS order → RigidState (E, …)."""
    comps, row = {}, 0
    for name, n in FIELDS:
        comps[name] = tuple(packed[row + k] for k in range(n))
        row += n
    return to_rigid(SoAState(**comps))


def _substep(scene: SceneParams, s: SoAState, force) -> SoAState:
    """One dt substep; mirrors the reference soa._substep term by term."""
    dt = scene.dt
    g = scene.gravity
    inv_m = scene.inv_mass
    f = float

    # 1. integrate external forces into velocities
    cart_vel = (
        s.cart_vel[0] + f(dt * inv_m[0]) * force[0],
        s.cart_vel[1] + f(dt * inv_m[0]) * force[1],
        s.cart_vel[2] + f(dt) * (f(g[2]) + f(inv_m[0]) * force[2]),
    )
    pole_vel = (s.pole_vel[0], s.pole_vel[1], s.pole_vel[2] + f(dt * g[2]))
    if f(g[0]) != 0.0 or f(g[1]) != 0.0:
        cart_vel = (cart_vel[0] + f(dt * g[0]), cart_vel[1] + f(dt * g[1]), cart_vel[2])
        pole_vel = (pole_vel[0] + f(dt * g[0]), pole_vel[1] + f(dt * g[1]), pole_vel[2])
    cart_ang, pole_ang = s.cart_ang, s.pole_ang
    if f(scene.linear_damping) != 0.0:
        d = f(np.float32(1.0) - scene.linear_damping)
        cart_vel = v_scale(cart_vel, d)
        pole_vel = v_scale(pole_vel, d)
    if f(scene.angular_damping) != 0.0:
        d = f(np.float32(1.0) - scene.angular_damping)
        cart_ang = v_scale(cart_ang, d)
        pole_ang = v_scale(pole_ang, d)

    # 2. contact manifold (slot groups: G = 0-11 vs ground, P = 12-15).
    che = scene.cart_half_extents
    phe = scene.pole_half_extents
    r_cm = q_to_mat(s.cart_quat)
    r_pm = q_to_mat(s.pole_quat)

    def corners_world_mat(pos, rmat, signs, he):
        """pos + R·(signs*he) as 3 component tensors of (k, E)."""
        cols = tuple(tuple(rmat[j][k] * f(he[k]) for j in range(3)) for k in range(3))
        comps = []
        for j in range(3):
            rows = []
            for k in range(signs.shape[0]):
                e = pos[j]
                for ax in range(3):
                    e = e + cols[ax][j] if signs[k, ax] > 0 else e - cols[ax][j]
                rows.append(e)
            comps.append(torch.stack(rows, 0))
        return tuple(comps)

    cgw = corners_world_mat(s.cart_pos, r_cm, _CART_CORNERS, che)  # (4, E)
    pgw = corners_world_mat(s.pole_pos, r_pm, _POLE_CORNERS8, phe)  # (8, E)
    pbw = tuple(c[:4] for c in pgw)
    e_shape = cgw[2].shape[1:]

    def rows_of(*groups):
        """Concatenate (count, value) groups into a slot plane."""
        return torch.cat([v[None].expand((n,) + e_shape) for n, v in groups])

    def g_rows(cart_comp, pole_comp):
        return rows_of((4, cart_comp), (8, pole_comp))

    def a_sel(cart_comp, pole_comp):
        return rows_of((4, cart_comp), (12, pole_comp))

    def b4(cart_comp):
        return cart_comp[None].expand((4,) + e_shape)

    # --- G group: penetration = -corner z, frame = world axes.
    pen_g = torch.cat([-cgw[2], -pgw[2]])  # (12, E)
    act_g = (pen_g > 0.0).to(pen_g.dtype)
    corners_g = tuple(torch.cat([cgw[k], pgw[k]]) for k in range(3))
    r_g = v_sub(corners_g, tuple(g_rows(c, p) for c, p in zip(s.cart_pos, s.pole_pos)))

    # --- P group: pole-bottom corners in the cart frame; top face z=+hz.
    rel = v_sub(pbw, (s.cart_pos[0][None], s.cart_pos[1][None], s.cart_pos[2][None]))
    in_cart = tuple(
        r_cm[0][k][None] * rel[0] + r_cm[1][k][None] * rel[1] + r_cm[2][k][None] * rel[2]
        for k in range(3)
    )
    pen_p = f(che[2]) - in_cart[2]
    act_p = (
        (torch.abs(in_cart[0]) <= f(che[0]) + TOP_FACE_MARGIN)
        & (torch.abs(in_cart[1]) <= f(che[1]) + TOP_FACE_MARGIN)
        & (pen_p > 0.0)
        & (pen_p < TOP_FACE_BAND * f(che[2]))
    ).to(pen_p.dtype)

    n_pc = (r_cm[0][2], r_cm[1][2], r_cm[2][2])
    n_p = tuple(b4(c) for c in n_pc)
    t1_e, t2_e = tangent_basis(n_pc)
    t1_p = tuple(b4(c) for c in t1_e)
    t2_p = tuple(b4(c) for c in t2_e)
    r_p = tuple(pbw[k] - s.pole_pos[k][None] for k in range(3))
    r_b4 = tuple(pbw[k] - s.cart_pos[k][None] for k in range(3))

    # 3. solver: mass-splitting Jacobi.
    iib = [[f(v) for v in row] for row in scene.inv_inertia_body]
    iiw_c = inv_inertia_world_mat(r_cm, iib[0])
    iiw_p = inv_inertia_world_mat(r_pm, iib[1])

    cnt_cart = torch.clamp(act_g[:4].sum(0) + act_p.sum(0), min=1.0)
    cnt_pole = torch.clamp(act_g[4:].sum(0) + act_p.sum(0), min=1.0)

    invm_c = f(inv_m[0]) * cnt_cart
    invm_p = f(inv_m[1]) * cnt_pole
    iic = tuple(tuple(iiw_c[i][j] * cnt_cart for j in range(3)) for i in range(3))
    iip = tuple(tuple(iiw_p[i][j] * cnt_pole for j in range(3)) for i in range(3))

    gx, gy, gz = r_g
    invm_g = g_rows(invm_c, invm_p)
    ii_g = tuple(tuple(g_rows(iic[i][j], iip[i][j]) for j in range(3)) for i in range(3))
    a0 = ii_g[0][0] * gy - ii_g[0][1] * gx
    a1 = ii_g[1][0] * gy - ii_g[1][1] * gx
    inv_kn_g = 1.0 / (invm_g + (a0 * gy - a1 * gx))
    b1 = ii_g[1][1] * gz - ii_g[1][2] * gy
    b2 = ii_g[2][1] * gz - ii_g[2][2] * gy
    inv_kt1_g = 1.0 / (invm_g + (b1 * gz - b2 * gy))
    c2 = ii_g[2][2] * gx - ii_g[2][0] * gz
    c0 = ii_g[0][2] * gx - ii_g[0][0] * gz
    inv_kt2_g = 1.0 / (invm_g + (c2 * gx - c0 * gz))

    invm_p4 = b4(invm_p)
    invm_b4 = b4(invm_c)
    ii_p = tuple(tuple(b4(iip[i][j]) for j in range(3)) for i in range(3))
    ii_b4 = tuple(tuple(b4(iic[i][j]) for j in range(3)) for i in range(3))

    def eff_inv_mass_p(d):
        rxd = v_cross(r_p, d)
        ird = m_vec(ii_p, rxd)
        k = invm_p4 + v_dot(d, v_cross(ird, r_p))
        rxd_b = v_cross(r_b4, d)
        ird_b = m_vec(ii_b4, rxd_b)
        k = k + (invm_b4 + v_dot(d, v_cross(ird_b, r_b4)))
        return 1.0 / k

    inv_kn_p = eff_inv_mass_p(n_p)
    inv_kt1_p = eff_inv_mass_p(t1_p)
    inv_kt2_p = eff_inv_mass_p(t2_p)

    pen = torch.cat([pen_g, pen_p])
    active = torch.cat([act_g, act_p])
    mu = rows_of(
        (4, torch.full(e_shape, f(scene.friction_cart_ground), dtype=pen.dtype, device=pen.device)),
        (8, torch.full(e_shape, f(scene.friction_pole_ground), dtype=pen.dtype, device=pen.device)),
        (4, torch.full(e_shape, f(scene.friction_pole_cart), dtype=pen.dtype, device=pen.device)),
    )
    r_a = tuple(torch.cat([r_g[k], r_p[k]]) for k in range(3))
    inv_kn = torch.cat([inv_kn_g, inv_kn_p]) * active
    inv_kt1 = torch.cat([inv_kt1_g, inv_kt1_p]) * active
    inv_kt2 = torch.cat([inv_kt2_g, inv_kt2_p]) * active

    bias = f(scene.baumgarte / dt) * torch.clamp(pen - f(scene.slop), min=0.0)

    def body_vel_at_slots(cv, ca, pv, pa):
        vel_a = tuple(a_sel(c, p) for c, p in zip(cv, pv))
        ang_a = tuple(a_sel(c, p) for c, p in zip(ca, pa))
        va = v_add(vel_a, v_cross(ang_a, r_a))
        vb4 = v_add(tuple(b4(c) for c in cv), v_cross(tuple(b4(c) for c in ca), r_b4))
        return tuple(torch.cat([vak[:12], vak[12:] - vb4k]) for vak, vb4k in zip(va, vb4))

    cv, ca, pv, pa = cart_vel, cart_ang, pole_vel, pole_ang
    jn = jt1 = jt2 = torch.zeros_like(pen)
    for _ in range(scene.solver_iterations):
        v = body_vel_at_slots(cv, ca, pv, pa)
        vp = tuple(c[12:] for c in v)
        vn = torch.cat([v[2][:12], v_dot(vp, n_p)])
        jn_new = torch.clamp(jn + (bias - vn) * inv_kn, min=0.0)
        dn = jn_new - jn
        bound = mu * jn_new
        vt1 = torch.cat([v[0][:12], v_dot(vp, t1_p)])
        vt2 = torch.cat([v[1][:12], v_dot(vp, t2_p)])
        jt1_new = torch.minimum(torch.maximum(jt1 - vt1 * inv_kt1, -bound), bound)
        jt2_new = torch.minimum(torch.maximum(jt2 - vt2 * inv_kt2, -bound), bound)
        d1 = jt1_new - jt1
        d2 = jt2_new - jt2

        dn_p, d1_p, d2_p = dn[12:], d1[12:], d2[12:]
        imp = tuple(
            torch.cat([dg, dn_p * a + d1_p * b + d2_p * c])
            for dg, a, b, c in zip((d1[:12], d2[:12], dn[:12]), n_p, t1_p, t2_p)
        )
        imp_cart = tuple(i[:4].sum(0) - i[12:].sum(0) for i in imp)
        imp_pole = tuple(i[4:].sum(0) for i in imp)
        cv = v_add(cv, v_scale(imp_cart, f(inv_m[0])))
        pv = v_add(pv, v_scale(imp_pole, f(inv_m[1])))

        tau_a = v_cross(r_a, imp)
        tau_b4 = v_cross(r_b4, tuple(i[12:] for i in imp))
        tau_cart = tuple(ta[:4].sum(0) - tb.sum(0) for ta, tb in zip(tau_a, tau_b4))
        tau_pole = tuple(ta[4:].sum(0) for ta in tau_a)
        ca = v_add(ca, m_vec(iiw_c, tau_cart))
        pa = v_add(pa, m_vec(iiw_p, tau_pole))
        jn, jt1, jt2 = jn_new, jt1_new, jt2_new

    # 4. integrate pose
    return SoAState(
        cart_pos=v_add(s.cart_pos, v_scale(cv, f(dt))),
        cart_quat=q_integrate(s.cart_quat, ca, dt),
        cart_vel=cv,
        cart_ang=ca,
        pole_pos=v_add(s.pole_pos, v_scale(pv, f(dt))),
        pole_quat=q_integrate(s.pole_quat, pa, dt),
        pole_vel=pv,
        pole_ang=pa,
    )


def _force_rows(cart_force: torch.Tensor):
    return tuple(cart_force[..., i] for i in range(3))


def step_substeps_batched(
    scene: SceneParams, state: RigidState, cart_force: torch.Tensor, num_substeps: int
) -> RigidState:
    """Plain version of K2: ``num_substeps`` substeps under a constant
    (E, 3) world-frame cart force → final RigidState."""
    s = from_rigid(state)
    force = _force_rows(cart_force)
    for _ in range(num_substeps):
        s = _substep(scene, s, force)
    return to_rigid(s)


def pose_rows(s: SoAState) -> torch.Tensor:
    """(E, 16) pose matrix: cart pos+quat, pole pos+quat, 2 zero pads."""
    zero = torch.zeros_like(s.cart_pos[0])
    return torch.stack(
        [*s.cart_pos, *s.cart_quat, *s.pole_pos, *s.pole_quat, zero, zero], -1
    )


def step_repeats_batched(
    scene: SceneParams, state: RigidState, cart_force: torch.Tensor,
    substeps_per_repeat: int, repeats: int,
) -> tuple[RigidState, torch.Tensor]:
    """Plain version of K1: ``repeats × substeps_per_repeat`` substeps with a
    pose snapshot after each repeat → (state, poses (R, E, 16))."""
    s = from_rigid(state)
    force = _force_rows(cart_force)
    poses = []
    for _ in range(repeats):
        for _ in range(substeps_per_repeat):
            s = _substep(scene, s, force)
        poses.append(pose_rows(s))
    return to_rigid(s), torch.stack(poses)

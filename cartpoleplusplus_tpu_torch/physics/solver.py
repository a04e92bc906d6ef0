"""Contact solver: mass-splitting Jacobi impulses over all 16 slots at
once.  Port of cartpoleplusplus_tpu.physics.solver.

Each iteration updates every slot simultaneously; each body's inverse mass
and inertia are scaled by its number of active contacts (mass splitting),
which keeps the simultaneous update from overshooting.  Impulses scatter
back to the two bodies through constant (2, 16) incidence matrices
(``contacts.INC_A``/``INC_B``).
Baumgarte velocity bias with slop, a friction pyramid over two tangents
clamped by μ·λₙ, restitution 0.  Leading dims of the state are free.
"""

from __future__ import annotations

import numpy as np
import torch

from cartpoleplusplus_tpu_torch.physics import math3d
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState, SceneParams
from cartpoleplusplus_tpu_torch.physics.contacts import Contacts, SceneConsts, scene_consts

def _world_inv_inertia(k: SceneConsts, state: RigidState) -> torch.Tensor:
    """World-frame inverse inertia tensors (…, 2, 3, 3) = R diag(I⁻¹) Rᵀ."""
    rot = math3d.quat_to_mat(state.quat)
    return torch.matmul(rot * k.inv_inertia_body[:, None, :], rot.transpose(-1, -2))


def solve(scene: SceneParams, state: RigidState, contacts: Contacts,
          consts: SceneConsts | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mass-splitting Jacobi on the velocity state → (vel, ang)
    (``consts``: the scene's :class:`SceneConsts` on the state's device,
    made here if not given)."""
    dev, dtype = state.vel.device, state.vel.dtype
    k = consts or scene_consts(scene, dev)
    inc_a, inc_b, mask_b, idx_a, idx_b = k.inc_a, k.inc_b, k.mask_b, k.idx_a, k.idx_b
    inv_mass = k.inv_mass  # (2,)
    inv_inertia = _world_inv_inertia(k, state)  # (…, 2, 3, 3)

    n = contacts.normal  # (…, C, 3)
    t1, t2 = math3d.make_tangent_basis(n)
    r_a, r_b = contacts.r_a, contacts.r_b
    active = contacts.active  # (…, C)

    # Mass splitting: per-body active-contact counts (fixed within the
    # substep: the manifold does not change during iterations).
    mv = lambda inc, x: torch.matmul(inc, x[..., None])[..., 0]
    count = torch.clamp(mv(inc_a, active) + mv(inc_b, active), min=1.0)  # (…, 2)
    n_a, n_b_cnt = count[..., idx_a], count[..., idx_b]  # (…, C)

    invm_a = inv_mass[idx_a] * n_a
    invm_b = inv_mass[idx_b] * n_b_cnt * mask_b
    inertia_a = inv_inertia[..., idx_a, :, :] * n_a[..., None, None]
    inertia_b = inv_inertia[..., idx_b, :, :] * (n_b_cnt * mask_b)[..., None, None]

    def eff_inv_mass(direction):
        def ang_term(inertia, r):
            rxd = math3d.cross(r, direction)
            return torch.sum(
                direction * math3d.cross(torch.matmul(inertia, rxd[..., None])[..., 0], r),
                dim=-1)

        k = invm_a + ang_term(inertia_a, r_a) + invm_b + ang_term(inertia_b, r_b)
        return 1.0 / k

    inv_kn = eff_inv_mass(n)
    inv_kt1 = eff_inv_mass(t1)
    inv_kt2 = eff_inv_mass(t2)

    # Baumgarte velocity bias: drive penetrating contacts apart.
    bias = float(np.float32(scene.baumgarte) / np.float32(scene.dt)) * torch.clamp(
        contacts.penetration - float(scene.slop), min=0.0)

    def rel_vel(vel, ang):
        """(…, C, 3) relative velocity at every slot."""
        v_a = vel[..., idx_a, :] + math3d.cross(ang[..., idx_a, :], r_a)
        v_b = vel[..., idx_b, :] + math3d.cross(ang[..., idx_b, :], r_b)
        return v_a - mask_b[:, None] * v_b

    def apply_impulses(vel, ang, imp):
        """Scatter (…, C, 3) impulse vectors back to the 2 bodies."""
        signed = torch.matmul(inc_a, imp) - torch.matmul(inc_b, imp)  # (…, 2, 3)
        vel = vel + inv_mass[:, None] * signed
        tau_a = math3d.cross(r_a, imp)
        tau_b = math3d.cross(r_b, imp)
        tau = torch.matmul(inc_a, tau_a) - torch.matmul(inc_b, tau_b)
        ang = ang + torch.matmul(inv_inertia, tau[..., None])[..., 0]
        return vel, ang

    vel, ang = state.vel, state.ang
    jn = jt1 = jt2 = torch.zeros(active.shape, dtype=dtype, device=dev)
    for _ in range(scene.solver_iterations):
        v = rel_vel(vel, ang)

        # Normal phase: accumulated clamping at 0, all slots at once.
        vn = torch.sum(v * n, dim=-1)
        jn_new = torch.clamp(jn + (bias - vn) * inv_kn * active, min=0.0)
        dn = jn_new - jn

        # Friction phase on the same pre-impulse velocities, the pyramid
        # clamped at the updated normal impulse.
        bound = contacts.mu * jn_new
        vt1 = torch.sum(v * t1, dim=-1)
        vt2 = torch.sum(v * t2, dim=-1)
        jt1_new = torch.clamp(jt1 - vt1 * inv_kt1 * active, -bound, bound)
        jt2_new = torch.clamp(jt2 - vt2 * inv_kt2 * active, -bound, bound)
        d1 = jt1_new - jt1
        d2 = jt2_new - jt2

        imp = dn[..., None] * n + d1[..., None] * t1 + d2[..., None] * t2
        vel, ang = apply_impulses(vel, ang, imp)
        jn, jt1, jt2 = jn_new, jt1_new, jt2_new
    return vel, ang

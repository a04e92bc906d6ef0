"""Rigid-body stepping, array-of-structs: port of
cartpoleplusplus_tpu.physics.engine.

Semi-implicit Euler with contacts, per substep:
  1. integrate external forces into velocities (gravity + cart push),
  2. detect contacts at the current pose (contacts.py),
  3. resolve velocities with Jacobi impulses (solver.py),
  4. integrate positions/orientations with the corrected velocities.

The state's leading dims are free — (2, 3) for one env, (E, 2, 3) for a
batch — so one implementation serves both, as JAX's ``vmap`` did.  This is
the per-env step's physics (env/cartpole.py ``reset``/``step``); it runs
as plain PyTorch on the device it is given.  The batched paths run the SoA
substep (soa.py) or its kernels (K1/K2), held against this one.
"""

from __future__ import annotations

import numpy as np
import torch

from cartpoleplusplus_tpu_torch.physics import contacts as contacts_mod
from cartpoleplusplus_tpu_torch.physics import math3d, solver
from cartpoleplusplus_tpu_torch.physics.bodies import CART, RigidState, SceneParams
from cartpoleplusplus_tpu_torch.physics.contacts import SceneConsts, scene_consts


def substep(scene: SceneParams, state: RigidState, cart_force: torch.Tensor,
            consts: SceneConsts | None = None) -> RigidState:
    """Advance one substep of ``scene.dt`` seconds.  ``cart_force``
    (…, 3): world-frame force at the cart's COM (no torque).  ``consts``:
    the scene's :class:`~contacts.SceneConsts` on the state's device, made
    here if not given."""
    dt = np.float32(scene.dt)
    k = consts or scene_consts(scene, state.vel.device)
    # 1. External forces → velocities (semi-implicit: forces first).
    vel = state.vel + k.gravity_dt
    push = float(dt * np.float32(scene.inv_mass[CART])) * cart_force
    vel = torch.cat([(vel[..., CART, :] + push)[..., None, :], vel[..., CART + 1:, :]], dim=-2)
    ang = state.ang
    # Bullet-style damping (defaults 0).
    vel = vel * float(np.float32(1.0) - np.float32(scene.linear_damping))
    ang = ang * float(np.float32(1.0) - np.float32(scene.angular_damping))

    pre = RigidState(pos=state.pos, quat=state.quat, vel=vel, ang=ang)
    # 2-3. Contacts and impulse resolution.
    manifold = contacts_mod.generate(scene, pre, k)
    vel, ang = solver.solve(scene, pre, manifold, k)
    # 4. Integrate the pose with the corrected velocities.
    pos = state.pos + float(dt) * vel
    quat = math3d.quat_integrate(state.quat, ang, dt)
    return RigidState(pos=pos, quat=quat, vel=vel, ang=ang)


def step_substeps(scene: SceneParams, state: RigidState, cart_force: torch.Tensor,
                  num_substeps: int, consts: SceneConsts | None = None) -> RigidState:
    """``num_substeps`` substeps holding the applied force constant, on
    one :class:`~contacts.SceneConsts` (``consts``, or made once here)."""
    k = consts or scene_consts(scene, state.vel.device)
    for _ in range(num_substeps):
        state = substep(scene, state, cart_force, k)
    return state


def kinetic_energy(scene: SceneParams, state: RigidState) -> torch.Tensor:
    """Total kinetic energy over the last two dims (…,)."""
    mass = torch.from_numpy(np.asarray(scene.mass, np.float32)).to(state.vel.device)
    lin = 0.5 * torch.sum(mass[:, None] * state.vel ** 2, dim=(-2, -1))
    # ω in the body frame meets the diagonal inertia.
    w_body = math3d.quat_rotate_inv(state.quat, state.ang)
    inv_i = torch.from_numpy(np.asarray(scene.inv_inertia_body, np.float32)).to(w_body.device)
    rot = 0.5 * torch.sum(w_body ** 2 / inv_i, dim=(-2, -1))
    return lin + rot


def potential_energy(scene: SceneParams, state: RigidState) -> torch.Tensor:
    """Gravitational potential energy (g along -z) (…,)."""
    mg = torch.from_numpy(
        np.asarray(scene.mass, np.float32) * -np.asarray(scene.gravity, np.float32)[2]
    ).to(state.pos.device)
    return torch.sum(mg * state.pos[..., 2], dim=-1)

"""Scene description for the cartpole++ world: ground plane + cart + pole.

Mirrors cartpoleplusplus_tpu.physics.bodies.  Scene constants stay host
numpy float32, as in the reference: the plain PyTorch physics reads them as
Python floats and the CUDA kernel receives them in a parameter struct, so
both see the same float32 values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CART = 0
POLE = 1
NUM_BODIES = 2


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """All physical constants of the 3-body scene (host numpy float32)."""

    cart_half_extents: np.ndarray  # (3,)
    pole_half_extents: np.ndarray  # (3,)
    mass: np.ndarray  # (2,) [cart, pole]
    inv_mass: np.ndarray  # (2,)
    inv_inertia_body: np.ndarray  # (2, 3) diagonal body-frame inverse inertia
    friction_cart_ground: np.float32
    friction_pole_cart: np.float32
    friction_pole_ground: np.float32
    restitution: np.float32
    dt: np.float32
    gravity: np.ndarray  # (3,)
    baumgarte: np.float32
    slop: np.float32
    linear_damping: np.float32
    angular_damping: np.float32
    solver_iterations: int = 3


def make_scene(
    cart_half_extents=(0.25, 0.25, 0.1),
    pole_half_extents=(0.05, 0.05, 0.5),
    cart_mass=10.0,
    pole_mass=0.1,
    friction_cart_ground=0.05,
    friction_pole_cart=0.8,
    friction_pole_ground=0.6,
    restitution=0.0,
    dt=1.0 / 240.0,
    gravity_z=-9.81,
    baumgarte=0.2,
    slop=1e-4,
    linear_damping=0.0,
    angular_damping=0.0,
    solver_iterations=3,
) -> SceneParams:
    """Scene constants; same defaults and float32 arithmetic as the JAX
    package's make_scene."""
    f32 = np.float32
    cart_he = np.asarray(cart_half_extents, f32)
    pole_he = np.asarray(pole_half_extents, f32)
    mass = np.asarray([cart_mass, pole_mass], f32)
    inv_mass = 1.0 / mass

    def _box_inertia(m, he):
        hx, hy, hz = he
        return (m / 3.0) * np.asarray(
            [hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy], f32
        )

    inertia = np.stack([_box_inertia(mass[0], cart_he), _box_inertia(mass[1], pole_he)])
    return SceneParams(
        cart_half_extents=cart_he,
        pole_half_extents=pole_he,
        mass=mass,
        inv_mass=inv_mass,
        inv_inertia_body=1.0 / inertia,
        friction_cart_ground=f32(friction_cart_ground),
        friction_pole_cart=f32(friction_pole_cart),
        friction_pole_ground=f32(friction_pole_ground),
        restitution=f32(restitution),
        dt=f32(dt),
        gravity=np.asarray([0.0, 0.0, gravity_z], f32),
        baumgarte=f32(baumgarte),
        slop=f32(slop),
        linear_damping=f32(linear_damping),
        angular_damping=f32(angular_damping),
        solver_iterations=solver_iterations,
    )


@dataclasses.dataclass
class RigidState:
    """Dynamic state of the two free bodies, batched over envs.

    pos (E, 2, 3), quat (E, 2, 4) (w, x, y, z), vel (E, 2, 3),
    ang (E, 2, 3) world-frame angular velocity.
    """

    pos: torch.Tensor
    quat: torch.Tensor
    vel: torch.Tensor
    ang: torch.Tensor

    def map(self, fn, *others: "RigidState") -> "RigidState":
        """Apply ``fn`` field by field (to this state and ``others``)."""
        return RigidState(**{
            f.name: fn(getattr(self, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)
        })


def rest_state(scene: SceneParams, num_envs: int, device) -> RigidState:
    """Cart at origin on the ground, pole upright on the cart top, (E, …)."""
    cart_z = float(scene.cart_half_extents[2])
    pole_z = float(np.float32(2.0 * scene.cart_half_extents[2] + scene.pole_half_extents[2]))
    pos = torch.tensor([[0.0, 0.0, cart_z], [0.0, 0.0, pole_z]], dtype=torch.float32)
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * NUM_BODIES, dtype=torch.float32)
    zeros = torch.zeros((NUM_BODIES, 3), dtype=torch.float32)
    batch = lambda x: x.to(device).expand((num_envs,) + x.shape).contiguous()
    return RigidState(pos=batch(pos), quat=batch(quat), vel=batch(zeros), ang=batch(zeros))

"""Analytic contact generation for the cartpole++ scene: port of
cartpoleplusplus_tpu.physics.contacts.

A static manifold of 16 candidate contact points whose activity is a 0/1
mask, so every env has the same shapes:

  [0:4)   cart bottom corners  vs ground plane
  [4:12)  pole corners (all 8) vs ground plane
  [12:16) pole bottom corners  vs cart top face

Pole↔cart side-face contact is not modelled (as in the JAX version).  The
state's leading dims are free: a state (…, 2, 3) gives a manifold
(…, 16, ·).  :class:`SceneConsts` holds the scene's constants and the
manifold's static tables on one device, for the substeps (engine.py) to
share.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from cartpoleplusplus_tpu_torch.physics import math3d
from cartpoleplusplus_tpu_torch.physics.bodies import (CART, NUM_BODIES, POLE, RigidState,
                                                       SceneParams)

# Static per-slot body indices: body_a receives +impulse along the normal,
# body_b (or the static ground, -1) receives the reaction.
BODY_A = (CART,) * 4 + (POLE,) * 8 + (POLE,) * 4
BODY_B = (-1,) * 4 + (-1,) * 8 + (CART,) * 4
N_CONTACTS = len(BODY_A)

_BOTTOM4 = tuple(itertools.product((-1.0, 1.0), (-1.0, 1.0), (-1.0,)))
_ALL8 = tuple(itertools.product((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0)))

# Pole corners may sink at most this fraction of the cart's half-height into
# its top face before the slot deactivates (deeper means beside the cart).
_TOP_FACE_BAND = 0.5

# Static incidence: INC_A[b, c] = 1 iff slot c's body_a is b (same for B;
# the ground's slots are 0 in INC_B).
_IDX_A = np.asarray(BODY_A)
_IDX_B = np.asarray([max(b, 0) for b in BODY_B])
_MASK_B = np.asarray([1.0 if b >= 0 else 0.0 for b in BODY_B], np.float32)
INC_A = np.zeros((NUM_BODIES, N_CONTACTS), np.float32)
INC_A[_IDX_A, np.arange(N_CONTACTS)] = 1.0
INC_B = np.zeros((NUM_BODIES, N_CONTACTS), np.float32)
INC_B[_IDX_B, np.arange(N_CONTACTS)] = _MASK_B


@dataclasses.dataclass(frozen=True)
class SceneConsts:
    """A scene's constants and the manifold's static tables on one device,
    made once by :func:`scene_consts` for the substeps that follow: a copy
    from pageable host memory waits for the card, so none is made per
    substep."""

    gravity_dt: torch.Tensor  # (3,) dt·g
    inv_mass: torch.Tensor  # (2,)
    inv_inertia_body: torch.Tensor  # (2, 3)
    cart_bottom: torch.Tensor  # (4, 3) cart bottom corners, body frame
    pole_corners: torch.Tensor  # (8, 3) pole corners, body frame
    pole_bottom: torch.Tensor  # (4, 3) pole bottom corners, body frame
    up: torch.Tensor  # (3,)
    inc_a: torch.Tensor  # (2, 16)
    inc_b: torch.Tensor  # (2, 16)
    mask_b: torch.Tensor  # (16,) 0 where body_b is the ground
    idx_a: torch.Tensor  # (16,) int64
    idx_b: torch.Tensor  # (16,) int64, the ground's slots at 0


def scene_consts(scene: SceneParams, device) -> SceneConsts:
    """``scene``'s :class:`SceneConsts` on ``device``."""
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    corners = lambda half, signs: f32(np.asarray(signs, np.float32)
                                      * np.asarray(half, np.float32))
    return SceneConsts(
        gravity_dt=f32(np.float32(scene.dt) * np.asarray(scene.gravity, np.float32)),
        inv_mass=f32(scene.inv_mass), inv_inertia_body=f32(scene.inv_inertia_body),
        cart_bottom=corners(scene.cart_half_extents, _BOTTOM4),
        pole_corners=corners(scene.pole_half_extents, _ALL8),
        pole_bottom=corners(scene.pole_half_extents, _BOTTOM4),
        up=f32((0.0, 0.0, 1.0)), inc_a=f32(INC_A), inc_b=f32(INC_B), mask_b=f32(_MASK_B),
        idx_a=torch.from_numpy(_IDX_A).to(device), idx_b=torch.from_numpy(_IDX_B).to(device))


@dataclasses.dataclass
class Contacts:
    """Per-slot contact geometry, leading dims as the state's."""

    normal: torch.Tensor  # (…, 16, 3) world, points from b (or ground) into a
    r_a: torch.Tensor  # (…, 16, 3) contact point relative to body_a COM
    r_b: torch.Tensor  # (…, 16, 3) relative to body_b COM (zeros for ground)
    penetration: torch.Tensor  # (…, 16) >= 0 where active
    active: torch.Tensor  # (…, 16) float 0/1 mask
    mu: torch.Tensor  # (…, 16) friction coefficient per slot


def generate(scene: SceneParams, state: RigidState,
             consts: SceneConsts | None = None) -> Contacts:
    """Contact manifold at the current pose (``consts``: the scene's
    :class:`SceneConsts` on the state's device, made here if not given)."""
    pos, quat = state.pos, state.quat
    k = consts or scene_consts(scene, pos.device)
    lead = pos.shape[:-2]
    cart_pos, pole_pos = pos[..., CART, :], pos[..., POLE, :]
    cart_quat, pole_quat = quat[..., CART, :], quat[..., POLE, :]
    up = k.up

    def full(n, value):
        return torch.full(lead + (n,), float(value), dtype=pos.dtype, device=pos.device)

    # Cart corners vs ground.
    cart_local = k.cart_bottom  # (4, 3)
    cart_world = cart_pos[..., None, :] + math3d.quat_rotate(cart_quat[..., None, :], cart_local)
    cart_pen = -cart_world[..., 2]
    cart_active = (cart_pen > 0.0).to(pos.dtype)
    cart_normal = up.expand(lead + (4, 3))
    cart_r_a = cart_world - cart_pos[..., None, :]
    cart_r_b = torch.zeros(lead + (4, 3), dtype=pos.dtype, device=pos.device)
    cart_mu = full(4, scene.friction_cart_ground)

    # Pole corners vs ground.
    pole_local = k.pole_corners  # (8, 3)
    pole_world = pole_pos[..., None, :] + math3d.quat_rotate(pole_quat[..., None, :], pole_local)
    pg_pen = -pole_world[..., 2]
    pg_active = (pg_pen > 0.0).to(pos.dtype)
    pg_normal = up.expand(lead + (8, 3))
    pg_r_a = pole_world - pole_pos[..., None, :]
    pg_r_b = torch.zeros(lead + (8, 3), dtype=pos.dtype, device=pos.device)
    pg_mu = full(8, scene.friction_pole_ground)

    # Pole bottom corners vs the cart's top face, in the cart's frame (the
    # face is z = +hz there).
    bottom_local = k.pole_bottom
    bottom_world = pole_pos[..., None, :] + math3d.quat_rotate(
        pole_quat[..., None, :], bottom_local)
    in_cart = math3d.quat_rotate_inv(cart_quat[..., None, :], bottom_world - cart_pos[..., None, :])
    hx, hy, hz = (np.float32(v) for v in scene.cart_half_extents)
    pc_pen = float(hz) - in_cart[..., 2]
    # A small footprint margin keeps the resting pole from chattering off
    # the face under float32 jitter.
    margin = np.float32(1e-3)
    inside = (
        (torch.abs(in_cart[..., 0]) <= float(hx + margin))
        & (torch.abs(in_cart[..., 1]) <= float(hy + margin))
        & (pc_pen > 0.0)
        & (pc_pen < float(np.float32(_TOP_FACE_BAND) * hz))
    )
    pc_active = inside.to(pos.dtype)
    pc_normal = math3d.quat_rotate(cart_quat, up)[..., None, :].expand(lead + (4, 3))
    pc_r_a = bottom_world - pole_pos[..., None, :]
    pc_r_b = bottom_world - cart_pos[..., None, :]
    pc_mu = full(4, scene.friction_pole_cart)

    cat = lambda *xs: torch.cat(xs, dim=len(lead))
    return Contacts(
        normal=cat(cart_normal, pg_normal, pc_normal),
        r_a=cat(cart_r_a, pg_r_a, pc_r_a),
        r_b=cat(cart_r_b, pg_r_b, pc_r_b),
        penetration=cat(cart_pen, pg_pen, pc_pen),
        active=cat(cart_active, pg_active, pc_active),
        mu=cat(cart_mu, pg_mu, pc_mu),
    )

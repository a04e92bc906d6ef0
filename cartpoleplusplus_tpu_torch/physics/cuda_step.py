"""Wrappers of the CUDA physics kernels K1/K2 (csrc/physics.cu).

Counterparts of cartpoleplusplus_tpu.physics.pallas_step:
``step_repeats`` ↔ ``step_repeats_pallas`` (K1) and ``step_substeps`` ↔
``step_substeps_pallas`` (K2).  For CUDA tensors they launch the kernel;
for CPU tensors they run the plain PyTorch version in physics/soa.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.physics import soa
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState, SceneParams

POSE_COLS = 16


class PhysParams(ctypes.Structure):
    """Mirror of ``struct PhysParams`` in csrc/physics.cu."""

    _fields_ = [
        ("dt", ctypes.c_float),
        ("dt_inv_m0", ctypes.c_float),
        ("inv_m0", ctypes.c_float),
        ("inv_m1", ctypes.c_float),
        ("g2", ctypes.c_float),
        ("dt_g0", ctypes.c_float),
        ("dt_g1", ctypes.c_float),
        ("dt_g2", ctypes.c_float),
        ("tilted_gravity", ctypes.c_int),
        ("lin_damp", ctypes.c_int),
        ("lin_damp_factor", ctypes.c_float),
        ("ang_damp", ctypes.c_int),
        ("ang_damp_factor", ctypes.c_float),
        ("cart_he", ctypes.c_float * 3),
        ("pole_he", ctypes.c_float * 3),
        ("top_x", ctypes.c_float),
        ("top_y", ctypes.c_float),
        ("top_band", ctypes.c_float),
        ("iib_c", ctypes.c_float * 3),
        ("iib_p", ctypes.c_float * 3),
        ("mu_cg", ctypes.c_float),
        ("mu_pg", ctypes.c_float),
        ("mu_pc", ctypes.c_float),
        ("bias_scale", ctypes.c_float),
        ("slop", ctypes.c_float),
        ("half_dt", ctypes.c_float),
        ("solver_iterations", ctypes.c_int),
    ]


def phys_params(scene: SceneParams) -> PhysParams:
    """Scene constants in float32, computed as physics/soa.py computes them."""
    f32 = np.float32
    dt, g, inv_m = scene.dt, scene.gravity, scene.inv_mass
    che, phe = scene.cart_half_extents, scene.pole_half_extents
    arr3 = lambda v: (ctypes.c_float * 3)(*(float(x) for x in v))
    return PhysParams(
        dt=dt, dt_inv_m0=dt * inv_m[0], inv_m0=inv_m[0], inv_m1=inv_m[1], g2=g[2],
        dt_g0=dt * g[0], dt_g1=dt * g[1], dt_g2=dt * g[2],
        tilted_gravity=int(float(g[0]) != 0.0 or float(g[1]) != 0.0),
        lin_damp=int(float(scene.linear_damping) != 0.0),
        lin_damp_factor=f32(1.0) - scene.linear_damping,
        ang_damp=int(float(scene.angular_damping) != 0.0),
        ang_damp_factor=f32(1.0) - scene.angular_damping,
        cart_he=arr3(che), pole_he=arr3(phe),
        top_x=float(che[0]) + soa.TOP_FACE_MARGIN,
        top_y=float(che[1]) + soa.TOP_FACE_MARGIN,
        top_band=soa.TOP_FACE_BAND * float(che[2]),
        iib_c=arr3(scene.inv_inertia_body[0]), iib_p=arr3(scene.inv_inertia_body[1]),
        mu_cg=scene.friction_cart_ground, mu_pg=scene.friction_pole_ground,
        mu_pc=scene.friction_pole_cart,
        bias_scale=scene.baumgarte / dt, slop=scene.slop,
        half_dt=f32(0.5) * dt,
        solver_iterations=int(scene.solver_iterations),
    )


def _check_inputs(state: RigidState, cart_force: torch.Tensor) -> int:
    e = state.pos.shape[0]
    for name, t, shape in (("pos", state.pos, (e, 2, 3)), ("quat", state.quat, (e, 2, 4)),
                           ("vel", state.vel, (e, 2, 3)), ("ang", state.ang, (e, 2, 3)),
                           ("cart_force", cart_force, (e, 3))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != state.pos.device:
            raise ValueError(f"{name} is on {t.device}, state on {state.pos.device}")
    if e == 0:
        raise ValueError("no envs")
    return e


def launch(
    params: PhysParams, packed: torch.Tensor, force: torch.Tensor, out: torch.Tensor,
    poses: torch.Tensor | None, repeats: int, substeps: int,
) -> None:
    """Launch the physics kernel on prepared CUDA buffers: state ``packed``
    (26, E), ``force`` (3, E) and ``out`` (26, E), all contiguous float32;
    ``poses`` (R, E, 16) or None, 16-byte aligned.  Counts nothing: the
    wrappers count."""
    if poses is not None and poses.data_ptr() % 16:
        raise ValueError("poses must be 16-byte aligned (the kernel stores float4)")
    err = kernels.library().cp_physics_step(
        ctypes.addressof(params), packed.data_ptr(), force.data_ptr(), out.data_ptr(),
        None if poses is None else poses.data_ptr(), packed.shape[1], repeats, substeps,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    kernels.check(err, "physics")


def _launch(name, scene, state, cart_force, repeats, substeps, with_poses):
    e = _check_inputs(state, cart_force)
    packed = soa.pack_state(state).contiguous()
    out = torch.empty_like(packed)
    poses = (torch.empty((repeats, e, POSE_COLS), dtype=torch.float32, device=packed.device)
             if with_poses else None)
    launch(phys_params(scene), packed, cart_force.t().contiguous(), out, poses, repeats, substeps)
    kernels.LAUNCHES[name] += 1
    return soa.unpack_state(out), poses


def step_repeats(
    scene: SceneParams, state: RigidState, cart_force: torch.Tensor,
    substeps_per_repeat: int, repeats: int,
) -> tuple[RigidState, torch.Tensor]:
    """K1: one env step's physics → (state, poses (R, E, 16))."""
    dev = state.pos.device
    if dev.type == "cpu":
        return soa.step_repeats_batched(scene, state, cart_force, substeps_per_repeat, repeats)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch("step_repeats", scene, state, cart_force, repeats, substeps_per_repeat, True)


def step_substeps(
    scene: SceneParams, state: RigidState, cart_force: torch.Tensor, num_substeps: int
) -> RigidState:
    """K2: ``num_substeps`` substeps → final state."""
    dev = state.pos.device
    if dev.type == "cpu":
        return soa.step_substeps_batched(scene, state, cart_force, num_substeps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch("step_substeps", scene, state, cart_force, 1, num_substeps, False)[0]

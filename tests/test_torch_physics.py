"""PyTorch port of the SoA physics (the plain version of kernels K1/K2)
against the JAX package's XLA path, ``soa.step_substeps_batched``.

Inputs are made with numpy from a seed and fed to both.  Tolerance: atol
1e-5, the bound the JAX package holds its own Pallas kernel to
(tests/test_pallas_physics.py); both sides compute in float32 with the same
expression order, so only reduction order and libm rounding differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.physics import soa as jsoa
from cartpoleplusplus_tpu.physics.bodies import RigidState as JRigid
from cartpoleplusplus_tpu.physics.bodies import make_scene as jmake_scene
from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.physics import cuda_step, soa
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState, make_scene, rest_state

torch.set_num_threads(2)

E = 32
ATOL = 1e-5


def _axis_angle_quat(axis, angle):
    axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
    return np.concatenate(
        [np.cos(angle / 2)[:, None], axis * np.sin(angle / 2)[:, None]], -1
    ).astype(np.float32)


def _cases(seed=0):
    """Resting, tilted, lifted and spinning states; forces in the plane."""
    rng = np.random.default_rng(seed)
    pos = np.tile(np.array([[0.0, 0.0, 0.1], [0.0, 0.0, 0.7]], np.float32), (E, 1, 1))
    quat = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (E, 2, 1))
    vel = np.zeros((E, 2, 3), np.float32)
    ang = np.zeros((E, 2, 3), np.float32)
    kind = np.arange(E) % 4
    # 1: pole tilted about a random horizontal axis
    tilt_axis = np.concatenate([rng.normal(size=(E, 2)), np.zeros((E, 1))], -1)
    quat[kind == 1, 1] = _axis_angle_quat(tilt_axis, rng.uniform(0.05, 0.4, E))[kind == 1]
    # 2: both bodies lifted and moving
    pos[kind == 2] += np.array([0.0, 0.0, 0.3], np.float32)
    vel[kind == 2] = rng.normal(0.0, 0.5, (E, 2, 3))[kind == 2]
    # 3: cart slid and rotated, pole spinning
    pos[kind == 3, :, :2] += rng.uniform(-0.5, 0.5, (E, 1, 2))[kind == 3]
    quat[kind == 3, 0] = _axis_angle_quat(
        np.tile([0.0, 0.0, 1.0], (E, 1)), rng.uniform(-1, 1, E))[kind == 3]
    ang[kind == 3, 1] = rng.normal(0.0, 1.0, (E, 3))[kind == 3]
    force = (rng.normal(0.0, 30.0, (E, 3)) * np.array([1.0, 1.0, 0.0])).astype(np.float32)
    return (pos.astype(np.float32), quat, vel.astype(np.float32), ang.astype(np.float32)), force


def _torch_state(arrs):
    return RigidState(*(torch.from_numpy(a.copy()) for a in arrs))


def _jax_state(arrs):
    return JRigid(*(jnp.asarray(a) for a in arrs))


def _assert_state_close(got: RigidState, ref: JRigid, atol=ATOL):
    for field in ("pos", "quat", "vel", "ang"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)), atol=atol,
            rtol=0, err_msg=field,
        )


def _jax_poses(ref):
    return np.concatenate(
        [np.asarray(ref.pos[:, 0]), np.asarray(ref.quat[:, 0]), np.asarray(ref.pos[:, 1]),
         np.asarray(ref.quat[:, 1]), np.zeros((ref.pos.shape[0], 2), np.float32)], -1)


def test_scene_constants_match_jax():
    jscene, scene = jmake_scene(), make_scene()
    for f in dataclasses.fields(scene):
        got, want = getattr(scene, f.name), getattr(jscene, f.name)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=f.name)
        assert np.asarray(got).dtype == np.asarray(want).dtype or f.name == "solver_iterations"


def test_rest_state_matches_jax():
    from cartpoleplusplus_tpu.physics.bodies import rest_state as jrest

    got = rest_state(make_scene(), 3, "cpu")
    want = jrest(jmake_scene())
    for field in ("pos", "quat", "vel", "ang"):
        np.testing.assert_array_equal(getattr(got, field)[1].numpy(), np.asarray(getattr(want, field)))


@pytest.mark.parametrize("num_substeps", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_substeps_match_jax(num_substeps, seed):
    arrs, force = _cases(seed)
    ref = jax.jit(lambda s, f: jsoa.step_substeps_batched(jmake_scene(), s, f, num_substeps))(
        _jax_state(arrs), jnp.asarray(force))
    got = soa.step_substeps_batched(make_scene(), _torch_state(arrs), torch.from_numpy(force),
                                    num_substeps)
    _assert_state_close(got, ref)


def test_repeats_match_jax_with_poses():
    """K1's plain version: R repeats of S substeps, pose snapshot per repeat."""
    arrs, force = _cases(2)
    spr, repeats = 2, 3
    step = jax.jit(lambda s, f: jsoa.step_substeps_batched(jmake_scene(), s, f, spr))
    ref, want_poses = _jax_state(arrs), []
    for _ in range(repeats):
        ref = step(ref, jnp.asarray(force))
        want_poses.append(_jax_poses(ref))
    got, poses = soa.step_repeats_batched(
        make_scene(), _torch_state(arrs), torch.from_numpy(force), spr, repeats)
    assert poses.shape == (repeats, E, 16)
    np.testing.assert_allclose(poses.numpy(), np.stack(want_poses), atol=ATOL, rtol=0)
    _assert_state_close(got, ref)


def test_wrappers_run_plain_version_on_cpu():
    """On CPU tensors the K1/K2 wrappers are the plain version, bit for bit,
    and launch nothing."""
    arrs, force = _cases(3)
    scene, f = make_scene(), torch.from_numpy(force)
    kernels.reset_launches()
    got = cuda_step.step_substeps(scene, _torch_state(arrs), f, 2)
    want = soa.step_substeps_batched(scene, _torch_state(arrs), f, 2)
    got_r, poses = cuda_step.step_repeats(scene, _torch_state(arrs), f, 1, 2)
    want_r, want_poses = soa.step_repeats_batched(scene, _torch_state(arrs), f, 1, 2)
    for a, b in ((got, want), (got_r, want_r)):
        for field in ("pos", "quat", "vel", "ang"):
            assert torch.equal(getattr(a, field), getattr(b, field))
    assert torch.equal(poses, want_poses)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_pack_unpack_roundtrip():
    arrs, _ = _cases(4)
    state = _torch_state(arrs)
    packed = soa.pack_state(state)
    assert packed.shape == (soa.N_ROWS, E)
    back = soa.unpack_state(packed)
    for field in ("pos", "quat", "vel", "ang"):
        assert torch.equal(getattr(back, field), getattr(state, field))


def test_kernel_params_match_plain_constants():
    """The CUDA parameter struct carries the float32 constants the plain
    version uses."""
    scene = make_scene()
    p = cuda_step.phys_params(scene)
    f32 = np.float32
    assert p.dt_inv_m0 == f32(scene.dt * scene.inv_mass[0])
    assert p.bias_scale == f32(scene.baumgarte / scene.dt)
    assert p.top_x == f32(float(scene.cart_half_extents[0]) + soa.TOP_FACE_MARGIN)
    assert p.top_band == f32(soa.TOP_FACE_BAND * float(scene.cart_half_extents[2]))
    assert p.half_dt == f32(0.5) * scene.dt
    assert list(p.iib_p) == [float(v) for v in scene.inv_inertia_body[1]]
    assert p.solver_iterations == scene.solver_iterations == 3
    assert not (p.tilted_gravity or p.lin_damp or p.ang_damp)


def test_rest_is_stable():
    """The pole rests on the cart: 60 substeps at zero force barely move it."""
    scene = make_scene()
    state = rest_state(scene, 4, "cpu")
    out = soa.step_substeps_batched(scene, state, torch.zeros((4, 3)), 60)
    np.testing.assert_allclose(out.pos[:, 1, 2].numpy(), 0.7, atol=5e-3)
    assert float(out.vel.abs().max()) < 0.05

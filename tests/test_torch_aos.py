"""The per-env physics of the port (``physics/{math3d,contacts,solver,
engine,urdf}.py``, array-of-structs) against the JAX package's AoS engine,
and the port's three physics paths pinned together as JAX's
tests/test_soa.py pins its own: the AoS engine, the plain SoA substep and
K1/K2 through their wrappers (on the CPU tensors here, the plain version).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: contacts, the solver and one substep at atol 1e-5 (the bound
of tests/test_pallas_physics.py; the solver's velocities also 1e-6
relative, for spins of tens of rad/s); a long horizon and AoS against SoA at
test_soa.py's own (2e-3 positions, 5e-3 quaternions over 120 substeps;
the fuzz's 1e-4/1e-4/5e-3/2e-2).  The JAX side runs jitted.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.physics import bodies as jbodies
from cartpoleplusplus_tpu.physics import contacts as jcontacts
from cartpoleplusplus_tpu.physics import engine as jengine
from cartpoleplusplus_tpu.physics import math3d as jmath3d
from cartpoleplusplus_tpu.physics import solver as jsolver
from cartpoleplusplus_tpu.physics import urdf as jurdf
from cartpoleplusplus_tpu_torch.physics import (
    contacts, cuda_step, engine, math3d, soa, solver, urdf)
from cartpoleplusplus_tpu_torch.physics.bodies import (
    CART, POLE, RigidState, make_scene, rest_state)

torch.set_num_threads(2)

ATOL = 1e-5
FIELDS = ("pos", "quat", "vel", "ang")


def _jrigid(arrs):
    return jbodies.RigidState(*(jnp.asarray(a) for a in arrs))


def _trigid(arrs):
    return RigidState(*(torch.from_numpy(np.asarray(a, np.float32).copy()) for a in arrs))


def _np(rigid):
    return [np.asarray(getattr(rigid, f)) if not torch.is_tensor(getattr(rigid, f))
            else getattr(rigid, f).numpy() for f in FIELDS]


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)]).astype(np.float32)


def _rest():
    base = rest_state(make_scene(), 1, "cpu")
    return [getattr(base, f)[0].numpy() for f in FIELDS]


def _cases():
    """test_soa.py's cases: free fall, rest, a pushed cart, a tilted pole, a
    pole sliding off → (states (5, 2, ·), forces (5, 3))."""
    pos, quat, vel, ang = _rest()
    states, forces = [], []

    def add(p=pos, q=quat, v=vel, f=(0.0, 0.0, 0.0)):
        states.append([p, q, v, ang])
        forces.append(np.asarray(f, np.float32))

    add(p=pos + np.float32([0.0, 0.0, 5.0]))
    add()
    add(f=(30.0, 10.0, 0.0))
    q = quat.copy()
    q[POLE] = _quat([0.0, 1.0, 0.0], 0.3)
    add(q=q)
    v = vel.copy()
    v[POLE] = [1.0, 0.5, 0.0]
    add(v=v, f=(-20.0, 0.0, 0.0))
    return [np.stack([s[i] for s in states]).astype(np.float32) for i in range(4)], \
        np.stack(forces)


def _fuzz(e=64, seed=7):
    """test_soa.py's fuzz: random poses near the ground, random velocities
    and forces."""
    rng = np.random.default_rng(seed)
    pos0, _, _, _ = _rest()

    def rand_quat():
        q = rng.normal(size=4)
        return q / np.linalg.norm(q)

    pos = np.tile(pos0[None], (e, 1, 1))
    pos[:, :, :2] += rng.uniform(-0.3, 0.3, size=(e, 2, 2))
    pos[:, :, 2] += rng.uniform(-0.02, 0.4, size=(e, 2))
    quat = np.stack([np.stack([rand_quat(), rand_quat()]) for _ in range(e)])
    vel = rng.uniform(-2.0, 2.0, size=(e, 2, 3))
    ang = rng.uniform(-4.0, 4.0, size=(e, 2, 3))
    forces = rng.uniform(-40.0, 40.0, size=(e, 3))
    return [a.astype(np.float32) for a in (pos, quat, vel, ang)], forces.astype(np.float32)


def _resets(e=16, seed=3, substeps=30):
    """Reset-like states: the pole jittered, then pushed for a number of
    substeps by JAX's engine (the per-env step's regime)."""
    rng = np.random.default_rng(seed)
    pos, quat, vel, ang = (np.tile(a[None], (e, 1, 1)) for a in _rest())
    for i in range(e):
        quat[i, POLE] = _quat(np.append(rng.normal(size=2), 0.0), 0.02 * (i + 1))
    theta = rng.uniform(0.0, 2 * np.pi, e)
    push = (55.0 * np.stack([np.cos(theta), np.sin(theta), 0 * theta], -1)).astype(np.float32)
    scene = jbodies.make_scene()
    out = jax.jit(jax.vmap(lambda s, f: jengine.step_substeps(scene, s, f, substeps)))(
        _jrigid((pos, quat, vel, ang)), jnp.asarray(push))
    return [np.asarray(a) for a in _np(out)], push


def _jax_aos(arrs, forces, n, scene=None):
    scene = scene or jbodies.make_scene()
    fn = jax.jit(jax.vmap(lambda s, f: jengine.step_substeps(scene, s, f, n)))
    return _np(fn(_jrigid(arrs), jnp.asarray(forces)))


def _assert_fields(got, want, tols, what=""):
    for f, g, w, tol in zip(FIELDS, got, want, tols):
        if tol is not None:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{what} {f}")


@pytest.mark.parametrize("fn", ["quat_normalize", "quat_mul", "quat_conj", "quat_rotate",
                                "quat_rotate_inv", "quat_to_mat", "quat_integrate",
                                "make_tangent_basis", "box_inertia", "quat_tilt_angle"])
def test_math3d_matches_jax(fn):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    qu = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    n = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    args = {
        "quat_normalize": (q,), "quat_mul": (qu, qu[::-1].copy()), "quat_conj": (qu,),
        "quat_rotate": (qu, v), "quat_rotate_inv": (qu, v), "quat_to_mat": (qu,),
        "quat_integrate": (qu, v, np.float32(1 / 240)), "make_tangent_basis": (n,),
        "box_inertia": (np.float32(0.1), np.abs(v)), "quat_tilt_angle": (qu,),
    }[fn]
    conv = lambda a, to: to(a) if isinstance(a, np.ndarray) and a.ndim else a
    want = getattr(jmath3d, fn)(*(conv(a, jnp.asarray) for a in args))
    got = getattr(math3d, fn)(*(conv(a, torch.from_numpy) for a in args))
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def _fallen(e=8, seed=5):
    """Poles lying on the ground beside the cart, sunk 0-2 mm, tumbling."""
    rng = np.random.default_rng(seed)
    pos, quat, vel, ang = (np.tile(a[None], (e, 1, 1)) for a in _rest())
    for i in range(e):
        yaw = rng.uniform(-np.pi, np.pi)
        pos[i, POLE] = [0.8 * np.cos(yaw), 0.8 * np.sin(yaw), 0.05 - 0.002 * i / e]
        quat[i, POLE] = _quat([-np.sin(yaw), np.cos(yaw), 0.0], np.pi / 2 + 0.05 * rng.normal())
    vel[:, POLE] = rng.uniform(-1.0, 1.0, size=(e, 3))
    ang[:, POLE] = rng.uniform(-2.0, 2.0, size=(e, 3))
    return [a.astype(np.float32) for a in (pos, quat, vel, ang)], np.zeros((e, 3), np.float32)


def _states():
    """Every regime: the test_soa cases, reset-like states, fallen poles,
    the fuzz."""
    parts = (_cases(), _resets(), _fallen(), _fuzz())
    return ([np.concatenate([p[0][i] for p in parts]) for i in range(4)],
            np.concatenate([p[1] for p in parts]))


def test_contacts_match_jax():
    arrs, _ = _states()
    jscene, scene = jbodies.make_scene(), make_scene()
    want = jax.jit(jax.vmap(lambda s: jcontacts.generate(jscene, s)))(_jrigid(arrs))
    got = contacts.generate(scene, _trigid(arrs))
    assert got.active.shape == (len(arrs[0]), contacts.N_CONTACTS)
    assert contacts.BODY_A == jcontacts.BODY_A and contacts.BODY_B == jcontacts.BODY_B
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    for f in ("normal", "r_a", "r_b", "penetration", "mu"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=ATOL, err_msg=f)
    # Every slot kind is exercised: ground contacts and the pole on the cart.
    act = got.active.numpy()
    assert act[:, :4].any() and act[:, 4:12].any() and act[:, 12:].any()


def test_solver_matches_jax():
    arrs, _ = _states()
    jscene, scene = jbodies.make_scene(), make_scene()

    def jsolve(s):
        return jsolver.solve(jscene, s, jcontacts.generate(jscene, s))

    jvel, jang = jax.jit(jax.vmap(jsolve))(_jrigid(arrs))
    state = _trigid(arrs)
    vel, ang = solver.solve(scene, state, contacts.generate(scene, state))
    # The fuzz's and the fallen poles' spins reach 29 rad/s after the solve,
    # where 1e-5 is five float32 ulps: the bound takes 1e-6 of |ω| on top.
    np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(ang.numpy(), np.asarray(jang), rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("which", ["cases", "resets", "fallen", "fuzz"])
def test_substep_matches_jax(which):
    """One substep, batched (E, 2, ·) and one env at a time (2, ·): the
    same numbers either way, within 1e-5 of JAX's ``engine.substep``."""
    arrs, forces = {"cases": _cases, "resets": _resets, "fallen": _fallen,
                    "fuzz": _fuzz}[which]()
    want = _jax_aos(arrs, forces, 1)
    scene = make_scene()
    got = engine.substep(scene, _trigid(arrs), torch.from_numpy(forces))
    _assert_fields(_np(got), want, (ATOL,) * 4, which)
    for i in range(min(len(forces), 4)):
        one = engine.substep(scene, _trigid([a[i] for a in arrs]), torch.from_numpy(forces[i]))
        for f in FIELDS:
            assert torch.equal(getattr(one, f), getattr(got, f)[i]), (i, f)


def test_energy_matches_jax():
    arrs, _ = _states()
    jscene, scene = jbodies.make_scene(), make_scene()
    state = _trigid(arrs)
    for jfn, fn in ((jengine.kinetic_energy, engine.kinetic_energy),
                    (jengine.potential_energy, engine.potential_energy)):
        want = jax.vmap(lambda s: jfn(jscene, s))(_jrigid(arrs))
        np.testing.assert_allclose(fn(scene, state).numpy(), np.asarray(want), rtol=1e-5)


def test_long_horizon_follows_jax():
    """120 substeps (0.5 s) of the cases and reset-like states: positions
    within 2e-3, quaternions within 5e-3 of JAX's AoS engine (test_soa.py's
    bounds for its own two paths)."""
    (c, cf), (r, rf) = _cases(), _resets()
    arrs, forces = [np.concatenate([a, b]) for a, b in zip(c, r)], np.concatenate([cf, rf])
    want = _jax_aos(arrs, forces, 120)
    got = _np(engine.step_substeps(make_scene(), _trigid(arrs), torch.from_numpy(forces), 120))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=5e-3)


def _paths(scene, arrs, forces, n):
    """The port's three physics paths on one batch: AoS, plain SoA, K2's
    wrapper (its plain version on CPU tensors) and K1's over n repeats of
    one substep."""
    state, f = _trigid(arrs), torch.from_numpy(forces)
    aos = engine.step_substeps(scene, state, f, n)
    plain = soa.step_substeps_batched(scene, state, f, n)
    k2 = cuda_step.step_substeps(scene, state, f, n)
    k1, poses = cuda_step.step_repeats(scene, state, f, 1, n)
    return aos, plain, k2, k1, poses


@pytest.mark.parametrize("n,tols", [(1, (ATOL,) * 4), (120, (2e-3, 5e-3, None, None))])
def test_aos_matches_soa_cases(n, tols):
    """test_soa.py's single-substep and long-horizon cases: the port's SoA
    paths against its AoS engine."""
    arrs, forces = _cases()
    aos, plain, k2, k1, poses = _paths(make_scene(), arrs, forces, n)
    for other in (plain, k2, k1):
        for f, tol in zip(FIELDS, tols):
            if tol is not None:
                np.testing.assert_allclose(getattr(other, f).numpy(), getattr(aos, f).numpy(),
                                           rtol=0, atol=tol, err_msg=f)
    np.testing.assert_allclose(poses[-1, :, :7].numpy(),
                               torch.cat([aos.pos[:, 0], aos.quat[:, 0]], -1).numpy(),
                               rtol=0, atol=max(t for t in tols[:2]))


def test_aos_matches_soa_fuzz():
    """test_soa.py's fuzz (12 substeps of random poses, velocities and
    forces) at its tolerances."""
    arrs, forces = _fuzz(e=256)
    aos, plain, k2, k1, _ = _paths(make_scene(), arrs, forces, 12)
    for other in (plain, k2, k1):
        _assert_fields(_np(other), _np(aos), (1e-4, 1e-4, 5e-3, 2e-2))


def test_aos_matches_soa_tilted_gravity():
    """A tilted gravity moves both paths alike (test_soa.py's case)."""
    import dataclasses

    scene = dataclasses.replace(make_scene(), gravity=np.array([1.5, -0.8, -9.81], np.float32))
    arrs, forces = _cases()
    aos, plain, _, _, _ = _paths(scene, arrs, forces, 30)
    assert float(plain.vel[0, :, 0].abs().min()) > 0.05
    _assert_fields(_np(plain), _np(aos), (1e-4, 1e-4, 5e-3, None))


def test_aos_rest_is_stable():
    """The rest state stays at rest for 2 s (test_soa.py's rest case)."""
    pos, quat, vel, ang = (np.tile(a[None], (2, 1, 1)) for a in _rest())
    out = engine.step_substeps(make_scene(), _trigid((pos, quat, vel, ang)),
                               torch.zeros((2, 3)), 480)
    np.testing.assert_allclose(out.pos[:, CART, 2].numpy(), 0.1, atol=5e-3)
    np.testing.assert_allclose(out.pos[:, POLE, 2].numpy(), 0.7, atol=5e-3)
    assert float(out.vel.abs().max()) < 0.05


def test_urdf_scenes_equal_jax():
    asset_dir = urdf.default_asset_dir()
    assert os.path.samefile(asset_dir, jurdf.default_asset_dir())
    for name in ("ground", "cart", "pole"):
        got = urdf.parse_urdf(os.path.join(asset_dir, f"{name}.urdf"))
        want = jurdf.parse_urdf(os.path.join(asset_dir, f"{name}.urdf"))
        assert vars(got) == vars(want), name
    for overrides in ({}, {"dt": 1.0 / 120.0, "solver_iterations": 5}):
        got = urdf.scene_from_urdf_dir(asset_dir, **overrides)
        want = jurdf.scene_from_urdf_dir(asset_dir, **overrides)
        for f in ("cart_half_extents", "pole_half_extents", "mass", "inv_mass",
                  "inv_inertia_body", "friction_cart_ground", "friction_pole_cart",
                  "friction_pole_ground", "restitution", "dt", "gravity", "baumgarte", "slop",
                  "linear_damping", "angular_damping", "solver_iterations"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)), err_msg=f)
    default = make_scene()
    got = urdf.scene_from_urdf_dir(asset_dir)
    np.testing.assert_allclose(got.inv_inertia_body, default.inv_inertia_body, rtol=1e-6)


def test_urdf_rejects_bad_files(tmp_path):
    (tmp_path / "x.urdf").write_text("<notrobot/>")
    with pytest.raises(ValueError, match="robot"):
        urdf.parse_urdf(str(tmp_path / "x.urdf"))
    for name in ("ground", "cart", "pole"):
        (tmp_path / f"{name}.urdf").write_text(
            '<robot name="b"><link name="l"><collision><geometry><box size="1 1 1"/>'
            "</geometry></collision></link></robot>")
    with pytest.raises(ValueError, match="plane"):
        urdf.scene_from_urdf_dir(str(tmp_path))

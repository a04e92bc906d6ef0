"""External physics fidelity of the port: its AoS engine
(``physics/engine.py``, one env on the CPU) against MuJoCo, in the five
cases of the JAX package's tests/test_fidelity_external.py and at that
file's envelopes: ballistic free flight, the friction slide (also against
v0 − µ·g·t), the forced cart (also against the closed form), the pole's
topple time (within 2 % of the analytic no-slip pivot time and of MuJoCo)
and the topple's settled resting pose.  The MuJoCo scene is that file's:
the same geometry, masses, frictions and dt, semi-implicit Euler.

Angular velocities in the ballistic case stay in the pole's x–y plane,
where the box is axisymmetric (Ix = Iy), so the gyroscopic term MuJoCo
integrates and the engine skips is zero by construction.
"""

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from cartpoleplusplus_tpu_torch.physics import engine  # noqa: E402
from cartpoleplusplus_tpu_torch.physics.bodies import (  # noqa: E402
    CART,
    POLE,
    make_scene,
    rest_state,
)

torch.set_num_threads(2)

DT = 1.0 / 240.0


_MJCF = """
<mujoco>
  <option timestep="{dt}" gravity="0 0 -9.81" integrator="Euler"/>
  <worldbody>
    <geom name="ground" type="plane" size="50 50 1" friction="{fg} 0 0"
          solref="0.002 1"/>
    <body name="cart" pos="{cart_pos}">
      <freejoint/>
      <geom type="box" size="0.25 0.25 0.1" mass="10" friction="0.05 0 0"
            solref="0.002 1"/>
    </body>
    <body name="pole" pos="{pole_pos}" quat="{pole_quat}">
      <freejoint/>
      <geom type="box" size="0.05 0.05 0.5" mass="0.1" friction="{fp} 0 0"
            solref="0.002 1"/>
    </body>
  </worldbody>
</mujoco>
"""


def _mj(cart_pos, pole_pos, pole_quat=(1, 0, 0, 0), fg=0.05, fp=0.6):
    """MuJoCo twin of physics.bodies.make_scene() geometry/materials."""
    xml = _MJCF.format(
        dt=DT, fg=fg, fp=fp,
        cart_pos=" ".join(map(str, cart_pos)),
        pole_pos=" ".join(map(str, pole_pos)),
        pole_quat=" ".join(map(str, pole_quat)),
    )
    m = mujoco.MjModel.from_xml_string(xml)
    return m, mujoco.MjData(m)


def _mj_run(m, d, n, cart_force=(0.0, 0.0, 0.0)):
    cart_id = m.body("cart").id
    for _ in range(n):
        d.xfrc_applied[cart_id, :3] = cart_force
        mujoco.mj_step(m, d)
    return d.qpos.copy(), d.qvel.copy()


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _rest(scene, **rows):
    """One env's rest state (2, …) with the given rows set: ``{field:
    {body: value}}``."""
    r = rest_state(scene, 1, "cpu").map(lambda x: x[0].clone())
    for field, by_body in rows.items():
        for body, value in by_body.items():
            getattr(r, field)[body] = torch.tensor(value, dtype=torch.float32)
    return r


def _ours(scene, rigid, n, force=(0.0, 0.0, 0.0)):
    f = torch.tensor(force, dtype=torch.float32)
    return engine.step_substeps(scene, rigid, f, n).map(lambda x: x.numpy())


def _tilt(quat_wxyz):
    w, x, y, z = quat_wxyz
    return np.arccos(np.clip(1.0 - 2.0 * (x * x + y * y), -1.0, 1.0))


def test_ballistic_free_flight_matches_mujoco(scene):
    """Contact-free pole flight: both engines integrate semi-implicit Euler
    at the same dt, so trajectories should agree to float32 noise."""
    pole_pos0 = np.array([3.0, -1.0, 5.0])
    v0 = np.array([1.0, 0.5, 2.0])
    w0 = np.array([0.6, -0.4, 0.0])  # planar spin: gyroscopic-free (Ix = Iy)

    r = _rest(scene, pos={POLE: pole_pos0}, vel={POLE: v0}, ang={POLE: w0})
    n = 60  # 0.25 s — pole falls ~0.3 m from z=5: no contact
    ours = _ours(scene, r, n)

    m, d = _mj((0, 0, 0.1), tuple(pole_pos0))
    d.qvel[6:9] = v0
    d.qvel[9:12] = w0
    qpos, qvel = _mj_run(m, d, n)

    assert np.abs(ours.pos[POLE] - qpos[7:10]).max() < 1e-4
    assert np.abs(ours.quat[POLE] - qpos[10:14]).max() < 1e-5
    assert np.abs(ours.vel[POLE] - qvel[6:9]).max() < 1e-4


def test_cart_friction_slide_matches_analytic_and_mujoco(scene):
    """Sliding cart under µ=0.05 Coulomb friction: v(t) = v0 − µ·g·t."""
    r = _rest(scene, pos={POLE: [5.0, 5.0, 0.5]}, vel={CART: [2.0, 0.0, 0.0]})
    n = 120  # 0.5 s
    ours = _ours(scene, r, n)

    m, d = _mj((0, 0, 0.1), (5, 5, 0.5))
    d.qvel[0] = 2.0
    qpos, qvel = _mj_run(m, d, n)

    analytic_v = 2.0 - 0.05 * 9.81 * n * DT
    assert abs(ours.vel[CART, 0] - analytic_v) < 1e-3
    assert abs(ours.vel[CART, 0] - qvel[0]) < 0.02
    assert abs(ours.pos[CART, 0] - qpos[0]) < 0.005


def test_forced_cart_matches_mujoco(scene):
    """50 N planar push (the env's action force) for 1 s on the sliding cart."""
    r = _rest(scene, pos={POLE: [5.0, 5.0, 0.5]})
    n = 240
    ours = _ours(scene, r, n, force=(50.0, 0.0, 0.0))

    m, d = _mj((0, 0, 0.1), (5, 5, 0.5))
    qpos, qvel = _mj_run(m, d, n, cart_force=(50.0, 0.0, 0.0))

    analytic_v = (50.0 / 10.0 - 0.05 * 9.81) * n * DT
    assert abs(ours.vel[CART, 0] - analytic_v) < 0.005
    assert abs(ours.vel[CART, 0] - qvel[0]) < 0.05
    assert abs(ours.pos[CART, 0] - qpos[0]) < 0.02


# Analytic no-slip corner-pivot topple time, 0.2 rad → 45°, for the 1.0 m ×
# 0.1 m uniform box pole: energy quadrature of ½·I_p·θ̇² = g·r_c·(cos(θ₀−α)
# − cos(θ−α)) with I_p the per-mass inertia about the bottom edge, r_c the
# center→edge distance and α = atan(hx/hz) the balance offset (the box
# balances at θ = α, so from 0.2 the center starts only ~0.1 rad past the
# apex — which is why the fall takes ~0.68 s, not an inverted-pendulum-from-
# vertical ~0.46 s).  Derivation + parameter sweeps: scripts/topple_analysis.py.
_T_TOPPLE_ANALYTIC = 0.6844


def test_pole_topple_time_matches_mujoco(scene):
    """Free-standing pole toppling from a 0.2 rad tilt, the contact
    behaviour the env hinges on: the time to 45°, read every 3 substeps
    (12.5 ms), within 2 % of the analytic no-slip pivot time and of
    MuJoCo's."""
    ang0 = 0.2
    q0 = np.array([np.cos(ang0 / 2), 0.0, np.sin(ang0 / 2), 0.0])

    r = _rest(scene, pos={POLE: [5.0, 0.0, 0.5]}, quat={POLE: q0})
    zero = torch.zeros(3)
    t_ours = None
    for i in range(1, 1200):
        r = engine.step_substeps(scene, r, zero, 3)
        if _tilt(r.quat[POLE].numpy()) > np.pi / 4:
            t_ours = i * 3 * DT
            break

    m, d = _mj((0, 0, 0.1), (5, 0, 0.5), pole_quat=tuple(q0))
    t_mj = None
    for i in range(1, 3600):
        mujoco.mj_step(m, d)
        if _tilt(d.qpos[10:14]) > np.pi / 4:
            t_mj = i * DT
            break

    assert t_ours is not None and t_mj is not None
    assert abs(t_ours - _T_TOPPLE_ANALYTIC) / _T_TOPPLE_ANALYTIC < 0.02, t_ours
    assert abs(t_mj - _T_TOPPLE_ANALYTIC) / _T_TOPPLE_ANALYTIC < 0.02, t_mj
    assert abs(t_ours - t_mj) / t_mj < 0.02, (t_ours, t_mj)


def test_topple_bounce_settle_envelope(scene):
    """The whole topple: the pole falls from 0.2 rad, hits the ground,
    bounces and slides, and must settle flat (tilt 90°, resting at its
    half-width, nearly still), where MuJoCo's pole rests within
    centimetres: impact, friction and resting contact, which the time to
    45° never reaches."""
    ang0 = 0.2
    q0 = np.array([np.cos(ang0 / 2), 0.0, np.sin(ang0 / 2), 0.0])
    r = _rest(scene, pos={POLE: [5.0, 0.0, 0.5]}, quat={POLE: q0})
    n = int(2.5 / DT)  # 2.5 s: topple ≈ 0.9 s + generous settling time
    ours = _ours(scene, r, n)

    tilt = _tilt(ours.quat[POLE])
    assert abs(tilt - np.pi / 2) < 0.05, tilt              # flat on the ground
    assert abs(ours.pos[POLE, 2] - 0.05) < 0.01            # resting at hx
    assert np.abs(ours.vel[POLE]).max() < 0.05             # motionless
    assert np.abs(ours.ang[POLE]).max() < 0.2

    m, d = _mj((0, 0, 0.1), (5, 0, 0.5), pole_quat=tuple(q0))
    qpos, qvel = _mj_run(m, d, n)
    assert abs(_tilt(d.qpos[10:14]) - np.pi / 2) < 0.05
    # Resting position agreement: the fall direction/length dominate; slide
    # friction differences show up here (bound, not exact match).
    assert np.abs(ours.pos[POLE, :2] - qpos[7:9]).max() < 0.08, (
        ours.pos[POLE], qpos[7:10]
    )
    assert abs(ours.pos[POLE, 2] - qpos[9]) < 0.01

"""The other three modes of the port's render kernel (the plain versions of
K5b, K5c and K5d) and their ``make_venv`` options, against the JAX package
on the CPU.

- K5b, the division-free ratio slab (``recip=False``): the cascade against
  JAX's ``raycast._ray_obb_affine(recip=None)`` evaluated op by op, exact
  equality expected (measured: equal); frames against the Pallas kernel in
  interpret mode, both launches, at the pixel rule of
  tests/test_pallas_render.py (|Δ| ≤ 2 on more than 99.9 % of values, mean
  |Δ| < 0.5; measured max |Δ| 0).
- K5c, the hoisted raster setup (``hoist``): ``pack_setups`` equal to JAX's
  ``_pack_setups`` as floats; frames byte-equal to the raster mode and to
  the Pallas kernel with ``hoist=True``.
- K5d, the bound planes as one product (``mxu``): frames against the Pallas
  kernel with ``mxu=True`` and against the port's raster mode under the JAX
  package's rule (tests/test_raster_render.py): under 1e-3 of bytes differ
  and every differing pixel lies within one pixel of a silhouette edge of
  more than 4 levels (measured on these inputs: no byte differs).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.env import cartpole as jcartpole
from cartpoleplusplus_tpu.physics.bodies import RigidState as JRigid
from cartpoleplusplus_tpu.render import pallas_kernel as jpk
from cartpoleplusplus_tpu.render import raycast as jraycast
from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.agents import ddpg
from cartpoleplusplus_tpu_torch.agents.common import make_venv
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.env.vector import resolve_obs
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.render import raycast
from cartpoleplusplus_tpu_torch.render.cuda_render import Renderer

from test_torch_render import _configs, _poses

torch.set_num_threads(2)

RATIO = dict(recip=False)
HOIST = dict(raster=True, hoist=True)
MXU = dict(raster=True, mxu=True)


def _rigid(arrs):
    return RigidState(*(torch.from_numpy(a) for a in arrs))


def _jax_frames(jcfg, arrs, form, **mode):
    """The Pallas kernel in interpret mode, in either launch form, as int32;
    the repeats form renders two repeats (the states and the states rolled
    by one env)."""
    scene = jcartpole.scene_for(jcfg)
    if form == "batched":
        render = jpk.make_render_batched(jcfg, tile_e=8, interpret=True, **mode)
        return np.asarray(render(scene, JRigid(*(jnp.asarray(a) for a in arrs))), np.int32)
    render = jpk.make_render_repeats(jcfg, tile_e=8, interpret=True, **mode)
    return np.asarray(render(scene, jnp.asarray(_repeat_poses(arrs).numpy())), np.int32)


def _repeat_poses(arrs):
    poses = raycast.poses_from_rigid(_rigid(arrs))
    return torch.stack([poses, torch.roll(poses, 1, dims=0)])


def _port_frames(cfg, arrs, form, **mode):
    renderer = Renderer(cfg, "cpu", **mode)
    scene = cartpole.scene_for(cfg)
    if form == "batched":
        return renderer.render_batched(scene, _rigid(arrs))
    return renderer.render_repeats(scene, _repeat_poses(arrs))


def _assert_pixels_close(got, want):
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert (diff <= 2).mean() > 0.999, f"{(diff > 2).mean():.4%} values off"
    assert diff.mean() < 0.5
    return int(diff.max())


def _edges(img, thresh=4):
    """(..., H, W) int: pixels with a 4-neighbour more than ``thresh`` away."""
    e = np.zeros(img.shape, bool)
    d = np.abs(np.diff(img, axis=-1)) > thresh
    e[..., :, :-1] |= d
    e[..., :, 1:] |= d
    d = np.abs(np.diff(img, axis=-2)) > thresh
    e[..., :-1, :] |= d
    e[..., 1:, :] |= d
    return e


def _dilate(mask):
    out = mask.copy()
    out[..., :-1, :] |= mask[..., 1:, :]
    out[..., 1:, :] |= mask[..., :-1, :]
    out[..., :, :-1] |= mask[..., :, 1:]
    out[..., :, 1:] |= mask[..., :, :-1]
    return out


def _assert_silhouette_rule(got, want, h, w):
    """tests/test_raster_render.py's rule for the product's rounding: under
    1e-3 of bytes differ, none off a silhouette edge."""
    g = np.asarray(got, np.int32).reshape(got.shape[0], -1, h, w)
    v = np.asarray(want, np.int32).reshape(g.shape)
    diff = g != v
    stray = diff & ~_dilate(_edges(g) | _edges(v))
    assert int(stray.sum()) == 0, f"{int(stray.sum())} differing pixels off silhouette edges"
    assert diff.mean() < 1e-3, f"{diff.mean():.5%} bytes differ"


@pytest.mark.parametrize("cam", [0, 1])
def test_ratio_cascade_matches_jax(cam):
    """num, den, lam and hit of both boxes equal JAX's op-by-op float32."""
    jcfg, cfg = _configs(2, 2, 2)
    planes, cam_meta, _ = raycast.ray_planes(cfg)
    basis, eye = cam_meta[cam]
    px, py = planes[0, cam].reshape(1, -1), planes[1, cam].reshape(1, -1)
    pos, quat, _, _ = _poses(3)
    scene = cartpole.scene_for(cfg)
    for box, he in ((0, scene.cart_half_extents), (1, scene.pole_half_extents)):
        center = tuple(pos[:, box, i : i + 1] for i in range(3))
        q = tuple(quat[:, box, i : i + 1] for i in range(4))
        got = raycast._ray_obb_affine(
            torch.from_numpy(px), torch.from_numpy(py), basis, eye,
            tuple(map(torch.from_numpy, center)), tuple(map(torch.from_numpy, q)), he,
            raycast.LIGHT_DIR, recip=False)
        want = jraycast._ray_obb_affine(
            jnp.asarray(px), jnp.asarray(py), basis, eye, tuple(map(jnp.asarray, center)),
            tuple(map(jnp.asarray, q)), he, jraycast.LIGHT_DIR, None)
        for name, g, w in zip(("num", "den", "lam", "hit"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert bool(got[3].any()) and not bool(got[3].all())


@pytest.mark.parametrize("form", ["batched", "repeats"])
@pytest.mark.parametrize("num_cameras,obs_pool,obs_samples", [(2, 2, 2), (1, 1, 0), (1, 2, 1)])
def test_ratio_frames_match_jax_kernel(num_cameras, obs_pool, obs_samples, form):
    jcfg, cfg = _configs(num_cameras, obs_pool, obs_samples)
    arrs = _poses(num_cameras + obs_pool)
    want = _jax_frames(jcfg, arrs, form, recip=False)
    got = _port_frames(cfg, arrs, form, **RATIO)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert _assert_pixels_close(got, want) == 0
    assert len(np.unique(want)) > 10


def test_ratio_frames_agree_with_reciprocal_slab():
    """The two slab cascades see the same scene (the JAX package's bound
    between its backends)."""
    _, cfg = _configs(2, 2, 2)
    arrs = _poses(4)
    ratio = _port_frames(cfg, arrs, "batched", **RATIO)
    _assert_pixels_close(ratio, _port_frames(cfg, arrs, "batched").numpy().astype(np.int32))


@pytest.mark.parametrize("lead", [(), (2,)])
def test_pack_setups_matches_jax(lead):
    """The packed (…, C·2·22) table over (E,) and (R, E) poses."""
    jcfg, cfg = _configs(2, 2, 0)
    poses = raycast.poses_from_rigid(_rigid(_poses(5)))
    if lead:
        poses = torch.stack([poses, torch.roll(poses, 3, dims=0)])
    _, cam_meta, _ = raycast.ray_planes(cfg)
    got = raycast.pack_setups(cartpole.scene_for(cfg), cam_meta, poses)
    want = jpk._pack_setups(jcartpole.scene_for(jcfg), cam_meta, jnp.asarray(poses.numpy()))
    assert tuple(got.shape) == (*lead, 16, 2 * 2 * raycast.SETUP_W) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpack_setup_inverts_pack():
    _, cfg = _configs(1, 2, 0)
    _, cam_meta, _ = raycast.ray_planes(cfg)
    scene = cartpole.scene_for(cfg)
    poses = raycast.poses_from_rigid(_rigid(_poses(6)))
    packed = raycast.pack_setups(scene, cam_meta, poses)
    col = lambda j: poses[:, j : j + 1]
    want = raycast._obb_q_setup(cam_meta[0][0], cam_meta[0][1], (col(7), col(8), col(9)),
                                (col(10), col(11), col(12), col(13)), scene.pole_half_extents,
                                raycast.LIGHT_DIR)
    got = raycast.unpack_setup(packed[:, raycast.SETUP_W :])
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["batched", "repeats"])
@pytest.mark.parametrize("num_cameras,obs_pool", [(1, 2), (2, 1)])
def test_hoist_frames_byte_equal(num_cameras, obs_pool, form):
    """Hoisted setup: byte-equal to the raster mode and to JAX's hoist."""
    jcfg, cfg = _configs(num_cameras, obs_pool, 0)
    arrs = _poses(7 + num_cameras)
    got = _port_frames(cfg, arrs, form, **HOIST)
    assert torch.equal(got, _port_frames(cfg, arrs, form, raster=True))
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  _jax_frames(jcfg, arrs, form, raster=True, hoist=True))


@pytest.mark.parametrize("form", ["batched", "repeats"])
@pytest.mark.parametrize("seed", [3, 11])
def test_mxu_frames_silhouette_rule(seed, form):
    """The product's bounds against JAX's mxu kernel and the port's raster,
    on row-major planes (obs_pool 1) so edges can be found."""
    jcfg, cfg = _configs(2, 1, 0)
    arrs = _poses(seed)
    got = _port_frames(cfg, arrs, form, **MXU)
    want_jax = _jax_frames(jcfg, arrs, form, raster=True, mxu=True)
    flat = lambda x: np.asarray(x).reshape(-1, np.asarray(x).shape[-1])
    _assert_silhouette_rule(flat(got.numpy()), flat(want_jax), 50, 50)
    raster = _port_frames(cfg, arrs, form, raster=True)
    _assert_silhouette_rule(flat(got.numpy()), flat(raster.numpy()), 50, 50)


def test_bound_planes_route_exactly():
    """Where the near plane is behind the eye, ub is BIG exactly, and where
    it is ahead, lb is -BIG exactly: the folded bias carries the routing."""
    import test_torch_raster

    _, cfg = _configs(2, 1, 0)
    planes, cam_meta, (p2, n) = raycast.ray_planes(cfg)
    pos, quat, _, _ = test_torch_raster._eye_inside_slab_states()
    col = lambda a, b, j: torch.from_numpy(a[:, b, j : j + 1])
    scene = cartpole.scene_for(cfg)
    su = [raycast._obb_q_setup(cam_meta[0][0], cam_meta[0][1], tuple(col(pos, b, j) for j in range(3)),
                               tuple(col(quat, b, j) for j in range(4)), he, raycast.LIGHT_DIR)
          for b, he in ((0, scene.cart_half_extents), (1, scene.pole_half_extents))]
    bounds = raycast.bound_planes(torch.from_numpy(planes[:, 0].reshape(4, p2 * n)), *su)
    for (a, ub, lb), s in zip(bounds, su):
        for k in range(3):
            ahead = s[5][k].expand_as(ub[k])
            assert bool((ub[k][~ahead] == raycast._BIG).all())
            assert bool((lb[k][ahead] == -raycast._BIG).all())
    assert not all(bool(a.all()) for a in su[1][5])  # the eye is inside a slab


def test_renderer_modes_and_counters():
    """Each flag's meaning, as in the JAX package: recip only in the slab
    mode, hoist and mxu only in the raster mode; on the CPU nothing counts."""
    _, cfg = _configs(1, 2, 0)
    cases = {
        (): ("", True), (("recip", False),): ("_ratio", False),
        (("raster", True),): ("_raster", True),
        (("raster", True), ("recip", False)): ("_raster", True),
        (("raster", True), ("hoist", True)): ("_raster_hoist", True),
        (("raster", True), ("mxu", True)): ("_raster_mxu", True),
        (("raster", True), ("hoist", True), ("mxu", True)): ("_raster_hoist_mxu", True),
        (("hoist", True), ("mxu", True)): ("", True),
    }
    for kw, (suffix, recip) in cases.items():
        r = Renderer(cfg, "cpu", **dict(kw))
        assert r.suffix == suffix and r.recip == recip
        for form in ("render_repeats", "render_batched"):
            assert form + suffix in kernels.LAUNCHES
    kernels.reset_launches()
    _port_frames(cfg, _poses(1), "repeats", raster=True, hoist=True, mxu=True)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


MODES = {
    "ratio": (dict(num_cameras=2, obs_samples=2), dict(render_recip=False), RATIO),
    "hoist": (dict(num_cameras=1, obs_samples=0), dict(render_hoist=True), HOIST),
    "mxu": (dict(num_cameras=1, obs_samples=0), dict(render_mxu=True), MXU),
    "hoist_mxu": (dict(num_cameras=1, obs_samples=0), dict(render_hoist=True, render_mxu=True),
                  dict(raster=True, hoist=True, mxu=True)),
}


def _mode_cfg(cfg_kw, **kw):
    return CartpoleConfig(discrete_actions=False, use_raw_pixels=True, obs_pool=2, **cfg_kw, **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_make_venv_option_frames(mode, monkeypatch):
    """Each option's reset and step frames are the plain version's frames
    in that mode, through both launches, and no other mode stands in."""
    cfg_kw, venv_kw, render_kw = MODES[mode]
    cfg = _mode_cfg(cfg_kw, action_repeats=2, steps_per_repeat=2)
    seen = []
    real = raycast.render_frames

    def spy(*args, **kwargs):
        seen.append({k: kwargs[k] for k in ("raster", "recip", "hoist", "mxu")})
        return real(*args, **kwargs)

    monkeypatch.setattr(raycast, "render_frames", spy)
    venv = make_venv(cfg, 8, device="cpu", **venv_kw)
    pool = venv.reset(torch.Generator().manual_seed(0))
    states, obs = pool
    want_mode = {"raster": False, "recip": True, "hoist": False, "mxu": False, **render_kw}
    if want_mode["raster"]:
        want_mode["recip"] = True
    else:
        want_mode["hoist"] = want_mode["mxu"] = False
    assert seen and all(s == want_mode for s in seen)
    planes, cam_meta, (p2, n) = raycast.ray_planes(cfg)
    frames = lambda rigid: real(
        venv.scene, raycast.poses_from_rigid(rigid), torch.from_numpy(planes), cam_meta, p2, n,
        **render_kw)
    assert torch.equal(obs[:, -1], frames(states.rigid))
    action = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (8, 2)).astype(np.float32))
    carried, obs2, _, done = venv.step_lazy(states, action, reset_pool=pool)
    assert len(seen) == 1 + cfg.action_repeats and all(s == want_mode for s in seen)
    next_states, _, _, _ = cartpole.step_batched(cfg, venv.scene, states, action, venv.sim_fn)
    assert torch.equal(obs2[:, -1], frames(next_states.rigid))
    assert resolve_obs(done, pool[1], obs2).shape == obs.shape


@pytest.mark.parametrize("mode", list(MODES))
def test_ddpg_segment_runs_with_option(mode):
    """One toy DDPG segment per option: the gate opens, losses are finite."""
    cfg_kw, venv_kw, _ = MODES[mode]
    cfg = _mode_cfg(cfg_kw, max_episode_len=5)
    venv = make_venv(cfg, 8, device="cpu", **venv_kw)
    st = ddpg.init_state(SimpleNamespace(seed=0, replay_capacity=32), cfg, venv, hidden=(16, 8))
    out = ddpg.make_segment(venv, gamma=0.99, tau=0.005, batch_size=4, warmup_steps=0,
                            steps_per_segment=3, ou_theta=0.15, ou_sigma=0.2)(st)
    assert float(out["updates"]) > 0
    assert all(np.isfinite(float(out[k])) for k in ("critic_loss", "actor_loss"))

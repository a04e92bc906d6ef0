"""PyTorch port of the slab renderer (the plain version of kernels K3/K4)
against the JAX package's XLA ray caster, ``raycast.make_observe_pixels``.

The port casts with the reciprocal slab cascade in float32 (what the
kernels compute); the reference casts with the division-free ratio cascade
in float32 and is quantized as tests/test_pallas_render.py quantizes it.
Bounds are the JAX package's own between its backends: |Δ| ≤ 2 on more
than 99.9% of pixels and mean |Δ| < 0.5; the golden image at
tests/test_golden_render.py's bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.env import cartpole as jcartpole
from cartpoleplusplus_tpu.physics.bodies import RigidState as JRigid
from cartpoleplusplus_tpu.render import make_observe_pixels as jmake_observe_pixels
from cartpoleplusplus_tpu.render import raycast as jraycast
from cartpoleplusplus_tpu.render.camera import DEFAULT_CAMERAS
from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState, rest_state
from cartpoleplusplus_tpu_torch.render import prefer_raster, raycast
from cartpoleplusplus_tpu_torch.render.cuda_render import Renderer

torch.set_num_threads(2)

E = 16
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_rest_render.npz")


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def _poses(seed=0):
    """Varied poses: shifted and yawed carts, poles tilted up to 0.6 rad,
    some fallen onto the ground."""
    rng = np.random.default_rng(seed)
    pos = np.tile(np.array([[0.0, 0.0, 0.1], [0.0, 0.0, 0.7]]), (E, 1, 1))
    quat = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (E, 2, 1))
    shift = rng.uniform(-0.6, 0.6, (E, 2))
    pos[:, :, :2] += shift[:, None]
    for i in range(E):
        quat[i, 0] = _quat([0, 0, 1], rng.uniform(-1.5, 1.5))
        tilt = rng.uniform(0.0, 0.6) if i % 4 else 1.4
        ax = np.append(rng.normal(size=2), 0.0)
        quat[i, 1] = _quat(ax, tilt)
        pos[i, 1, :2] += np.sin(tilt) * 0.5 * np.array([ax[1], -ax[0]]) / np.linalg.norm(ax)
        pos[i, 1, 2] = 0.2 + 0.5 * np.cos(tilt) if i % 4 else 0.06
    zeros = np.zeros((E, 2, 3))
    return tuple(a.astype(np.float32) for a in (pos, quat, zeros, zeros))


def _configs(num_cameras, obs_pool, obs_samples):
    kw = dict(use_raw_pixels=True, num_cameras=num_cameras, render_width=50,
              render_height=50, obs_pool=obs_pool, obs_samples=obs_samples)
    return JConfig(**kw), CartpoleConfig(**kw)


@pytest.mark.parametrize(
    "num_cameras,obs_pool,obs_samples",
    [(1, 1, 0), (2, 1, 0), (1, 2, 0), (2, 2, 2), (2, 2, 1)],
)
def test_render_matches_jax(num_cameras, obs_pool, obs_samples):
    jcfg, cfg = _configs(num_cameras, obs_pool, obs_samples)
    arrs = _poses(num_cameras + obs_pool)
    jscene = jcartpole.scene_for(jcfg)
    observe = jmake_observe_pixels(jcfg, dtype=jnp.float32)
    ref = jax.jit(jax.vmap(lambda r: observe(jscene, r)))(JRigid(*(jnp.asarray(a) for a in arrs)))
    ref_u8 = np.clip(np.asarray(ref, np.float32) * 255.0 + 0.5, 0.0, 255.0).astype(np.int32)

    got = raycast.make_observe_pixels(cfg)(
        cartpole.scene_for(cfg), RigidState(*(torch.from_numpy(a) for a in arrs)))
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == ref_u8.shape == (E, cfg.pixel_obs_shape[1])
    diff = np.abs(got.numpy().astype(np.int32) - ref_u8)
    assert (diff <= 2).mean() > 0.999, f"{(diff > 2).mean():.4%} pixels off"
    assert diff.mean() < 0.5
    # The frames are not blank: both bodies are visible somewhere.
    assert len(np.unique(ref_u8)) > 10


def test_rest_render_matches_golden():
    cfg = CartpoleConfig(use_raw_pixels=True, num_cameras=2)
    scene = cartpole.scene_for(cfg)
    frame = raycast.make_observe_pixels(cfg, dtype=torch.float32)(
        scene, rest_state(scene, 1, "cpu"))[0].numpy()
    golden = np.load(GOLDEN)["frame"]
    assert frame.shape == golden.shape
    diff = np.abs(frame - golden)
    assert (diff <= 2e-2).mean() > 0.9995, f"{(diff > 2e-2).mean():.4%} px changed"
    assert diff.mean() < 1e-3


@pytest.mark.parametrize("pool,samples", [(1, 0), (2, 0), (2, 2), (2, 1), (5, 3)])
def test_pool_ray_layout_matches_jax(pool, samples):
    got = raycast.pool_ray_layout(pool, 50, 50, samples)
    want = jraycast.pool_ray_layout(pool, 50, 50, samples)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("cam", [0, 1])
def test_static_background_matches_jax(cam):
    from cartpoleplusplus_tpu_torch.render.camera import ray_coords, ray_grid

    dirs, _ = ray_grid(DEFAULT_CAMERAS[cam], 50, 50)
    eye = ray_coords(DEFAULT_CAMERAS[cam], 50, 50)[3]
    d = (dirs[:, 0], dirs[:, 1], dirs[:, 2])
    for got, want in zip(raycast.static_background(d, eye), jraycast.static_background(d, eye)):
        np.testing.assert_array_equal(got, want)


def test_ray_planes_layout():
    """(4, C, p2, n) rows follow pool_ray_layout without the lane padding."""
    _, cfg = _configs(2, 2, 2)
    planes, cam_meta, (p2, n) = raycast.ray_planes(cfg)
    assert planes.shape == (4, 2, 2, 625) and (p2, n) == (2, 625) and len(cam_meta) == 2
    sel, (_, _, stride) = raycast.pool_ray_layout(2, 50, 50, 2)
    from cartpoleplusplus_tpu_torch.render.camera import ray_coords

    px = ray_coords(DEFAULT_CAMERAS[1], 50, 50)[0]
    np.testing.assert_array_equal(planes[0, 1, 1], px[sel[stride : stride + n]])


def test_renderer_cpu_is_plain_version():
    """On CPU the K3/K4 wrappers run the plain version and launch nothing;
    K3 equals K4 applied per repeat."""
    _, cfg = _configs(2, 2, 2)
    scene = cartpole.scene_for(cfg)
    renderer = Renderer(cfg, "cpu")
    rigids = [RigidState(*(torch.from_numpy(a) for a in _poses(s))) for s in range(3)]
    poses = torch.stack([raycast.poses_from_rigid(r) for r in rigids])
    kernels.reset_launches()
    got = renderer.render_repeats(scene, poses)
    want = torch.stack([renderer.render_batched(scene, r) for r in rigids], dim=1)
    assert got.shape == (E, 3, cfg.pixel_obs_shape[1])
    assert torch.equal(got, want)
    assert torch.equal(want[:, 0], raycast.make_observe_pixels(cfg)(scene, rigids[0]))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_prefer_raster_matches_jax():
    from cartpoleplusplus_tpu.render import prefer_raster as jprefer

    for args in [(1, 1, 0), (2, 2, 2), (2, 2, 0), (1, 2, 1)]:
        assert prefer_raster(*args) == jprefer(*args)

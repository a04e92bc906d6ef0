"""The raster mode of the port's renderer (the plain version of kernel K5a)
against the JAX package's XLA ray caster, ``raycast.make_observe_pixels``
with ``raster=True``, on the CPU.

Both sides cast in float32 and are quantized as the kernels quantize
(``floor(clip(c·255 + 0.5, 0, 255))``).  The bound is the JAX package's own
between its backends: |Δ| ≤ 2 on more than 99.9 % of values and mean
|Δ| < 0.5 (tests/test_pallas_render.py); on these inputs the two agree
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.env import cartpole as jcartpole
from cartpoleplusplus_tpu.physics.bodies import RigidState as JRigid
from cartpoleplusplus_tpu.render import make_observe_pixels as jmake_observe_pixels
from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.agents.common import make_venv
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.render import raycast
from cartpoleplusplus_tpu_torch.render.cuda_render import Renderer

from test_torch_render import _poses

torch.set_num_threads(2)


def _configs(num_cameras, obs_pool, obs_samples=0):
    kw = dict(use_raw_pixels=True, num_cameras=num_cameras, render_width=50,
              render_height=50, obs_pool=obs_pool, obs_samples=obs_samples)
    return JConfig(**kw), CartpoleConfig(**kw)


def _eye_inside_slab_states(e=8):
    """tests/test_raster_render.py's routing case: a pole lying at eye
    height near a camera, offset sideways so the eye is inside its long-axis
    and short z slabs but outside the box."""
    pos = np.zeros((e, 2, 3), np.float32)
    pos[:, 0, 2] = 0.1
    pos[:, 1, 2] = 1.1
    pos[:4, 1, 0], pos[:4, 1, 1] = 0.6, -2.0
    pos[4:, 1, 1], pos[4:, 1, 0] = 0.6, -2.0
    quat = np.zeros((e, 2, 4), np.float32)
    quat[:, :, 0] = 1.0
    quat[:4, 1] = np.array([np.cos(np.pi / 4), np.sin(np.pi / 4), 0, 0], np.float32)
    quat[4:, 1] = np.array([np.cos(np.pi / 4), 0, np.sin(np.pi / 4), 0], np.float32)
    zeros = np.zeros((e, 2, 3), np.float32)
    return pos, quat, zeros, zeros


def _jax_frames(jcfg, arrs):
    scene = jcartpole.scene_for(jcfg)
    observe = jmake_observe_pixels(jcfg, dtype=jnp.float32, raster=True)
    ref = jax.jit(jax.vmap(lambda r: observe(scene, r)))(JRigid(*(jnp.asarray(a) for a in arrs)))
    return np.clip(np.asarray(ref, np.float32) * 255.0 + 0.5, 0.0, 255.0).astype(np.int32)


def _assert_pixels_close(got, want):
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert (diff <= 2).mean() > 0.999, f"{(diff > 2).mean():.4%} values off"
    assert diff.mean() < 0.5


@pytest.mark.parametrize("num_cameras,obs_pool", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_raster_matches_jax(num_cameras, obs_pool):
    jcfg, cfg = _configs(num_cameras, obs_pool)
    arrs = _poses(10 + num_cameras + obs_pool)
    want = _jax_frames(jcfg, arrs)
    got = raycast.make_observe_pixels(cfg, raster=True)(
        cartpole.scene_for(cfg), RigidState(*(torch.from_numpy(a) for a in arrs)))
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == (arrs[0].shape[0], cfg.pixel_obs_shape[1])
    _assert_pixels_close(got, want)
    assert len(np.unique(want)) > 10  # both bodies are visible somewhere


@pytest.mark.parametrize("obs_pool", [1, 2])
def test_raster_eye_inside_slab_matches_jax(obs_pool):
    """The per-env routing of the near plane when the eye is inside a slab."""
    jcfg, cfg = _configs(2, obs_pool)
    arrs = _eye_inside_slab_states()
    setup = raycast._obb_q_setup(
        raycast.ray_planes(cfg)[1][0][0], raycast.ray_planes(cfg)[1][0][1],
        tuple(torch.from_numpy(arrs[0][:4, 1, i : i + 1]) for i in range(3)),
        tuple(torch.from_numpy(arrs[1][:4, 1, i : i + 1]) for i in range(4)),
        cartpole.scene_for(cfg).pole_half_extents, raycast.LIGHT_DIR)
    ahead, inside = setup[5], setup[7]
    assert not all(bool(a.all()) for a in ahead) and not bool(inside.any())
    got = raycast.make_observe_pixels(cfg, raster=True)(
        cartpole.scene_for(cfg), RigidState(*(torch.from_numpy(a) for a in arrs)))
    _assert_pixels_close(got, _jax_frames(jcfg, arrs))


def test_raster_agrees_with_slab():
    """The two cast modes see the same scene: frames differ only on
    silhouette edges (the JAX package measured ≤ 2e-5 of pixels)."""
    _, cfg = _configs(2, 2)
    scene = cartpole.scene_for(cfg)
    rigid = RigidState(*(torch.from_numpy(a) for a in _poses(5)))
    raster = raycast.make_observe_pixels(cfg, raster=True)(scene, rigid).int()
    slab = raycast.make_observe_pixels(cfg)(scene, rigid).int()
    diff = (raster - slab).abs()
    assert float((diff > 2).float().mean()) < 1e-3


def test_raster_renderer_cpu_is_plain_version():
    """On CPU the raster wrappers run the plain version and launch nothing;
    the repeats form equals the batched form applied per repeat."""
    _, cfg = _configs(1, 2)
    scene = cartpole.scene_for(cfg)
    renderer = Renderer(cfg, "cpu", raster=True)
    rigids = [RigidState(*(torch.from_numpy(a) for a in _poses(s))) for s in range(3)]
    poses = torch.stack([raycast.poses_from_rigid(r) for r in rigids])
    kernels.reset_launches()
    got = renderer.render_repeats(scene, poses)
    want = torch.stack([renderer.render_batched(scene, r) for r in rigids], dim=1)
    assert torch.equal(got, want)
    assert torch.equal(want[:, 0], raycast.make_observe_pixels(cfg, raster=True)(scene, rigids[0]))
    assert renderer.raster and (renderer.p2, renderer.n) == (4, 625)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


@pytest.mark.parametrize("render_raster,raster", [(None, True), (True, True), (False, False)])
def test_make_venv_on_an_exact_config_renders_raster(render_raster, raster, monkeypatch):
    """An exact config resolves to the raster mode through prefer_raster;
    its reset frame is the raster frame, and no slab frame stands in."""
    _, cfg = _configs(1, 2)
    seen = []
    real = raycast.render_frames

    def spy(*args, **kwargs):
        seen.append(kwargs.get("raster", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(raycast, "render_frames", spy)
    venv = make_venv(cfg, 4, device="cpu", render_raster=render_raster)
    state, obs = venv.reset(theta=torch.zeros(4), jitter=torch.zeros(4, 2))
    assert seen and all(s == raster for s in seen)
    want = raycast.make_observe_pixels(cfg, raster=raster)(venv.scene, state.rigid)
    assert torch.equal(obs[:, 0], want)

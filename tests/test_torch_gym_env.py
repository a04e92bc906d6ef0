"""The per-env surface of the port against the JAX package: the functional
``env.cartpole.reset``/``step`` (AoS physics, one frame per repeat), the
fresh-reset ``VectorCartpole.step``, ``env.gym_env.Cartpole`` (spaces, the
namespace constructor, ``render()``), ``render.raycast.frame_to_images``
and ``agents.torch_dqn_demo``.

JAX's draws are fed in: a reset's push direction and pole jitter are the
numbers JAX's ``reset`` draws from its key; actions come from numpy.
Tolerances: for the reset and the first 5 steps (75 substeps) states and
low-dim frames atol 1e-5, the angular velocity 1e-4 + 1e-4 relative (the
pole's spin about its long axis, inverse inertia 6e3, is ill-conditioned
in float32: the bound tests/test_torch_slice.py holds it to); after that
the long-horizon bounds JAX's tests/test_soa.py holds its own two engines
to, 2e-3 positions, 5e-3 quaternions (and frames), 5e-3 velocities, 2e-2
angular velocities (measured here over episodes of up to 21 steps: 3.5e-6,
4.8e-5, 1.1e-5, 4.2e-4); rewards 1e-6; done flags equal; pixel
frames by the JAX package's rule between its backends, |Δ| ≤ 2 levels on
≥ 99.9 % of pixels and mean |Δ| < 0.5, against JAX's float32 frames
quantized as the kernels quantize.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.env import cartpole as jcartpole
from cartpoleplusplus_tpu.env.vector import VectorCartpole as JVector
from cartpoleplusplus_tpu.render import make_observe_pixels as jmake_observe_pixels
from cartpoleplusplus_tpu.render import raycast as jraycast
from cartpoleplusplus_tpu_torch.agents import torch_dqn_demo
from cartpoleplusplus_tpu_torch.agents.common import make_venv
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.env.gym_env import BulletCartpole, Cartpole, pixel_observers
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.render import raycast

torch.set_num_threads(2)

ATOL = 1e-5
FIELDS = ("pos", "quat", "vel", "ang")
PIX = dict(render_width=20, render_height=20)
CASES = {
    "lowdim_discrete": dict(discrete_actions=True),
    "lowdim_continuous": dict(discrete_actions=False),
    "slab": dict(discrete_actions=False, use_raw_pixels=True, num_cameras=2, obs_pool=2,
                 obs_samples=2, **PIX),
    "raster": dict(discrete_actions=True, use_raw_pixels=True, num_cameras=1, obs_pool=2,
                   obs_samples=0, **PIX),
}


def _draws(key):
    """The push direction and pole jitter JAX's ``reset`` draws from key."""
    k_theta, k_jitter = jax.random.split(key)
    theta = jax.random.uniform(k_theta, (), minval=0.0, maxval=2.0 * jnp.pi)
    return torch.tensor(float(theta)), torch.from_numpy(
        np.array(jax.random.normal(k_jitter, (2,))))


def _quantize(frames):
    return np.clip(np.asarray(frames, np.float32) * 255.0 + 0.5, 0.0, 255.0).astype(np.int32)


def _pixel_rule(got, want, what=""):
    d = np.abs(np.asarray(got).astype(np.int32) - want)
    assert (d <= 2).mean() >= 0.999 and d.mean() < 0.5, (what, d.max(), (d <= 2).mean())


class _Pair:
    """One config on both sides: JAX's jitted reset/step (float32 pixel
    observer for pixel configs) and the port's with its CPU observers."""

    def __init__(self, **kw):
        self.jcfg, self.cfg = JConfig(**kw), CartpoleConfig(**kw)
        self.jscene, self.scene = jcartpole.scene_for(self.jcfg), cartpole.scene_for(self.cfg)
        jobs, self.reset_obs, self.step_obs = None, None, None
        if self.cfg.use_raw_pixels:
            raster = self.cfg.obs_samples == 0
            jobs = jmake_observe_pixels(self.jcfg, dtype=jnp.float32, raster=raster)
            self.reset_obs, self.step_obs = pixel_observers(self.cfg, "cpu", raster)
        self.jreset = jax.jit(lambda k: jcartpole.reset(self.jcfg, self.jscene, k, jobs))
        self.jstep = jax.jit(lambda s, a: jcartpole.step(self.jcfg, self.jscene, s, a, jobs))

    def reset(self, seed):
        key = jax.random.PRNGKey(seed)
        theta, jitter = _draws(key)
        want = self.jreset(key)
        got = cartpole.reset(self.cfg, self.scene, observe_fn=self.reset_obs, theta=theta,
                             jitter=jitter, device="cpu")
        return want, got

    def step(self, jstate, state, action):
        want = self.jstep(jstate, jnp.asarray(action))
        got = cartpole.step(self.cfg, self.scene, state, torch.as_tensor(action), self.step_obs)
        return want, got

    def compare_obs(self, jobs, obs, what, t=0):
        assert tuple(obs.shape) == (self.cfg.action_repeats,) + tuple(self.cfg.obs_shape[1:])
        if self.cfg.use_raw_pixels:
            assert obs.dtype == torch.uint8
            _pixel_rule(obs.numpy(), _quantize(jobs), what)
        else:
            np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0,
                                       atol=ATOL if t < TIGHT_STEPS else 5e-3, err_msg=what)


# Steps held at the one-substep bounds; later ones at the long-horizon ones.
TIGHT_STEPS = 5
TIGHT = {"pos": dict(atol=ATOL), "quat": dict(atol=ATOL), "vel": dict(atol=ATOL),
         "ang": dict(atol=1e-4, rtol=1e-4)}
LONG = {"pos": dict(atol=2e-3), "quat": dict(atol=5e-3), "vel": dict(atol=5e-3),
        "ang": dict(atol=2e-2)}


def _compare_state(jstate, state, what, t=0):
    for f in FIELDS:
        tol = {"rtol": 0, **(TIGHT if t < TIGHT_STEPS else LONG)[f]}
        np.testing.assert_allclose(getattr(state.rigid, f).numpy(),
                                   np.asarray(getattr(jstate.rigid, f)), err_msg=f"{what} {f}",
                                   **tol)
    assert int(state.steps) == int(jstate.steps) and bool(state.done) == bool(jstate.done)


def _action(cfg, rng):
    if cfg.discrete_actions:
        return np.int32(rng.integers(0, 5))
    return rng.uniform(-1.0, 1.0, 2).astype(np.float32)


def _episode(pair, seed, max_steps):
    """Reset with JAX's draws and roll numpy actions to the episode's end
    on both sides → the step count."""
    (jstate, jobs), (state, obs) = pair.reset(seed)
    _compare_state(jstate, state, "reset")
    pair.compare_obs(jobs, obs, "reset")
    rng = np.random.default_rng(seed)
    for t in range(max_steps):
        a = _action(pair.cfg, rng)
        (jstate, jobs, jrew, jdone), (state, obs, rew, done) = pair.step(jstate, state, a)
        _compare_state(jstate, state, f"step {t}", t)
        pair.compare_obs(jobs, obs, f"step {t}", t)
        np.testing.assert_allclose(float(rew), float(jrew), rtol=0, atol=1e-6)
        assert bool(done) == bool(jdone) and rew.shape == () and done.dtype == torch.bool
        if bool(done):
            return t + 1
    return max_steps


@pytest.mark.parametrize("case", sorted(CASES))
def test_reset_and_step_match_jax(case):
    """Three whole episodes per config (the reset's 30-substep push, then
    steps of 3 repeats × 5 substeps to termination or the 40-step cap)."""
    pair = _Pair(max_episode_len=40, **CASES[case])
    lengths = [_episode(pair, seed, 40) for seed in (1, 2, 3)]
    assert max(lengths) >= 2 * TIGHT_STEPS
    assert all(1 <= n <= 40 for n in lengths)


@pytest.mark.parametrize("reward_calc", ["fixed", "angle", "action", "angle_action"])
@pytest.mark.parametrize("discrete", [True, False])
def test_reward_modes_match_jax(reward_calc, discrete):
    """Every reward mode, discrete and continuous (JAX's per-env step
    computes the action modes too; only its batched step cannot)."""
    pair = _Pair(discrete_actions=discrete, reward_calc=reward_calc, max_episode_len=6,
                 action_repeats=2, steps_per_repeat=3)
    _episode(pair, 3, 6)


def test_termination_reasons_and_sticky_done():
    """Out of bounds, then the step cap; a step after done keeps done and
    pays 0, as JAX's."""
    pair = _Pair(discrete_actions=True, max_episode_len=40)
    (jstate, _), (state, _) = pair.reset(5)
    rng = np.random.default_rng(0)
    t = 0
    while not bool(state.done):
        a = np.int32(rng.integers(0, 5))
        (jstate, _, _, _), (state, _, _, _) = pair.step(jstate, state, a)
        t += 1
    assert t < 40  # fell, not timed out
    (jstate, _, jrew, jdone), (state, _, rew, done) = pair.step(jstate, state, np.int32(1))
    assert bool(done) and bool(jdone) and float(rew) == float(jrew) == 0.0

    env = Cartpole(CartpoleConfig(max_episode_len=3, action_repeats=1, steps_per_repeat=1),
                   device="cpu")
    env.reset()
    infos = [env.step(0)[3] for _ in range(3)]
    assert infos[:2] == [{}, {}] and infos[2] == {"done_reason": "max_episode_len"}
    env = Cartpole(CartpoleConfig(max_episode_len=40), device="cpu", seed=1)
    env.reset()
    done, info = False, {}
    while not done:
        _, _, done, info = env.step(1)
    assert info == {"done_reason": "out_of_bounds"}


@pytest.mark.parametrize("case", ["lowdim_discrete", "slab"])
def test_fresh_reset_vector_step_matches_jax(case):
    """``VectorCartpole.step`` without a pool draws a fresh reset batch from
    its generator: the same as the step given that batch as a pool, and,
    with JAX's draws fed to that batch, JAX's own step with ``rng``
    (max_episode_len 1: every env restarts)."""
    kw = dict(CASES[case], max_episode_len=1)
    jcfg, cfg = JConfig(**kw), CartpoleConfig(**kw)
    e = 8
    observe = None
    if cfg.use_raw_pixels:
        observe = jax.vmap(lambda r, f=jmake_observe_pixels(jcfg, dtype=jnp.float32):
                           f(jcartpole.scene_for(jcfg), r))
    jvenv = JVector(jcfg, e, observe_batched_fn=(lambda s, r: observe(r)) if observe else None)
    venv = make_venv(cfg, e, device="cpu", render_raster=False if cfg.use_raw_pixels else None)
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    kt, kj = jax.random.split(k0)
    start = venv.reset(theta=torch.from_numpy(np.array(jax.random.uniform(
        kt, (e,), minval=0.0, maxval=2.0 * jnp.pi))), jitter=torch.from_numpy(np.array(
            jax.random.normal(kj, (e, 2)))))
    jstart, _ = jvenv.reset(k0)
    action = (torch.arange(e) % 5) if cfg.discrete_actions else torch.linspace(-1, 1, 2 * e
                                                                               ).reshape(e, 2)

    g = torch.Generator().manual_seed(7)
    fresh = venv.step(start[0], action, generator=g)
    g2 = torch.Generator().manual_seed(7)
    pooled = venv.step(start[0], action, reset_pool=venv.reset(g2))
    assert bool(fresh[3].all())
    for a, b in zip(fresh[1:], pooled[1:]):
        assert torch.equal(a, b)
    for f in FIELDS:
        assert torch.equal(getattr(fresh[0].rigid, f), getattr(pooled[0].rigid, f))

    # Against JAX: its fresh reset from rng, ours from the same draws.
    kt, kj = jax.random.split(k1)
    pool = venv.reset(theta=torch.from_numpy(np.array(jax.random.uniform(
        kt, (e,), minval=0.0, maxval=2.0 * jnp.pi))), jitter=torch.from_numpy(np.array(
            jax.random.normal(kj, (e, 2)))))
    got = venv.step(start[0], action, reset_pool=pool)
    want = jax.jit(lambda s, a, k: jvenv.step(s, a, k))(jstart, jnp.asarray(action.numpy()), k1)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got[0].rigid, f).numpy(),
                                   np.asarray(getattr(want[0].rigid, f)),
                                   **{"rtol": 0, **TIGHT[f]})
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if cfg.use_raw_pixels:
        _pixel_rule(got[4].numpy(), _quantize(want[4]), "next_obs")
    else:
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=0, atol=ATOL)


def _opts(*argv):
    from cartpoleplusplus_tpu_torch.env.gym_env import add_opts

    parser = argparse.ArgumentParser()
    add_opts(parser)
    parser.add_argument("--continuous", action="store_true")
    return parser.parse_args(list(argv))


@pytest.mark.parametrize("argv", [
    ("--action-repeats", "2", "--steps-per-repeat", "2"),
    ("--use-raw-pixels", "--action-repeats", "2", "--steps-per-repeat", "2",
     "--render-width", "20", "--render-height", "20"),
    ("--continuous", "--use-raw-pixels", "--num-cameras", "2", "--obs-pool", "2",
     "--obs-samples", "2", "--render-width", "20", "--render-height", "20"),
])
def test_spaces_and_namespace_constructor(argv):
    """``BulletCartpole(opts)`` from an ``add_opts`` namespace, as JAX's:
    the same config and spaces; reset and step keep to the observation
    space."""
    from cartpoleplusplus_tpu.env.gym_env import BulletCartpole as JBulletCartpole

    opts = _opts(*argv)
    env = BulletCartpole(opts, device="cpu")
    jenv = JBulletCartpole(opts)
    for f in dataclasses.fields(env.config):
        assert getattr(env.config, f.name) == getattr(jenv.config, f.name), f.name
    for name in ("action_space", "observation_space"):
        got, want = getattr(env, name), getattr(jenv, name)
        assert type(got).__name__ == type(want).__name__
        assert got.shape == want.shape and got.dtype == want.dtype
        assert getattr(got, "n", None) == getattr(want, "n", None)
        assert (getattr(got, "low", None), getattr(got, "high", None)) == (
            getattr(want, "low", None), getattr(want, "high", None))
    obs = env.reset()
    assert obs.shape == env.observation_space.shape and obs.dtype == env.observation_space.dtype
    if env.config.use_raw_pixels:
        assert obs.max() > 100
    obs2, reward, done, info = env.step(env.action_space.sample())
    assert obs2.shape == obs.shape and obs2.dtype == obs.dtype
    assert isinstance(reward, float) and isinstance(done, bool) and isinstance(info, dict)
    assert env.seed(3) == [3]


def test_seed_repeats_episodes():
    env = Cartpole(CartpoleConfig(), device="cpu", seed=11)
    first = env.reset()
    env.seed(11)
    assert np.array_equal(env.reset(), first)
    assert not np.array_equal(env.reset(), first)


def test_render_matches_jax():
    """``render()``: camera 0 unpooled at the render size, (H, W, 3) uint8,
    against JAX's float32 caster on the same state, quantized (JAX's own
    ``render()`` shades in bfloat16, and on this sampled config raises: it
    keeps ``obs_samples`` 2 on the unpooled config; the port clears it)."""
    cfg = CartpoleConfig(render_width=32, render_height=32, use_raw_pixels=True, num_cameras=2,
                         obs_pool=2, obs_samples=2, discrete_actions=False)
    env = Cartpole(cfg, device="cpu", seed=2)
    with pytest.raises(RuntimeError, match="reset"):
        env.render()
    env.reset()
    for _ in range(2):
        env.step(np.zeros(2, np.float32))
    img = env.render()
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8 and img.max() > 100
    assert np.array_equal(env.render(mode="human"), img)
    one = JConfig(render_width=32, render_height=32, use_raw_pixels=True, num_cameras=1)
    from cartpoleplusplus_tpu.physics.bodies import RigidState as JRigid

    r = env._state.rigid
    frame = jmake_observe_pixels(one, dtype=jnp.float32)(
        jcartpole.scene_for(one), JRigid(*(jnp.asarray(getattr(r, f).numpy()) for f in FIELDS)))
    want = jraycast.frame_to_images(one, _quantize(frame))[0]
    _pixel_rule(img, want, "render")


def test_frame_to_images_matches_jax():
    cfg = CartpoleConfig(use_raw_pixels=True, num_cameras=2, obs_pool=2, **PIX)
    frames = np.random.default_rng(0).integers(0, 256, (3, 4) + cfg.pixel_obs_shape[1:],
                                               dtype=np.uint8)
    want = jraycast.frame_to_images(JConfig(use_raw_pixels=True, num_cameras=2, obs_pool=2,
                                            **PIX), frames)
    assert want.shape == (3, 4, 2, 10, 10, 3)
    np.testing.assert_array_equal(raycast.frame_to_images(cfg, frames), want)
    np.testing.assert_array_equal(raycast.frame_to_images(cfg, torch.from_numpy(frames)), want)


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    """Without a card, the gym env and the per-env reset raise unless the
    CPU is asked for; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Cartpole(CartpoleConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cartpole.reset(CartpoleConfig(), cartpole.scene_for(CartpoleConfig()),
                       theta=torch.tensor(0.0), jitter=torch.zeros(2))
    with pytest.raises(ValueError, match="generator"):
        cartpole.reset(CartpoleConfig(), cartpole.scene_for(CartpoleConfig()), device="cpu")
    Cartpole(CartpoleConfig(), device="cpu")


def test_torch_dqn_demo_trains_over_the_gym_env():
    """JAX tests/test_gym_interop.py's run: a whole external train loop
    (act, step, replay, backprop, target sync) over ``Cartpole`` returns a
    finite mean episode length within the cap."""
    mean_len = torch_dqn_demo.main([
        "--episodes", "6", "--batch-size", "16", "--eps-decay-episodes", "3",
        "--target-sync-steps", "50", "--action-repeats", "2", "--steps-per-repeat", "3",
        "--max-episode-len", "30", "--seed", "0", "--device", "cpu",
    ])
    assert np.isfinite(mean_len) and 1.0 <= mean_len <= 30.0


def test_torch_dqn_demo_builds_its_env_through_gym_env():
    opts = _opts("--action-repeats", "2", "--steps-per-repeat", "2")
    env = torch_dqn_demo.build_env(argparse.Namespace(**vars(opts), seed=0, device="cpu"))
    assert isinstance(env, Cartpole) and env.action_space.n == 5
    obs = env.reset()
    assert obs.shape == env.observation_space.shape == (2, 2, 7)
    obs2, reward, done, _ = env.step(env.action_space.sample())
    assert obs2.shape == obs.shape and isinstance(reward, float) and isinstance(done, bool)


def test_env_exports():
    """``env`` exports the per-env reset/step and the gym env, as the JAX
    package's ``env/__init__.py`` does."""
    from cartpoleplusplus_tpu_torch import env

    for name in ("reset", "step", "EnvState", "observe_lowdim", "action_to_force", "scene_for",
                 "CartpoleConfig", "add_opts", "config_from_opts", "Cartpole",
                 "BulletCartpole", "VectorCartpole", "DISCRETE_ACTIONS",
                 "NUM_DISCRETE_ACTIONS"):
        assert hasattr(env, name), name
    assert env.reset is cartpole.reset and env.step is cartpole.step
    assert isinstance(EnvState(rigid=RigidState(*(torch.zeros((2, 3)),) * 4),
                               steps=torch.zeros((), dtype=torch.int32),
                               done=torch.zeros((), dtype=torch.bool)), env.EnvState)

"""The port's acting slice end to end, against the JAX package on the CPU:
the DDPG ``Actor`` with weights carried across by ``utils/params.py``, and
``reset_batched`` + ``step_batched`` through ``make_venv``'s wiring (the
kernel wrappers, which run their plain versions on CPU tensors) against
the JAX XLA path fed the same pre-drawn randoms.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.env import cartpole as jcartpole
from cartpoleplusplus_tpu.models import Actor as JActor
from cartpoleplusplus_tpu.render import make_observe_pixels as jmake_observe_pixels
from cartpoleplusplus_tpu_torch.agents.common import eval_rollout, make_venv
from cartpoleplusplus_tpu_torch.agents.ddpg import greedy_act
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.env.vector import resolve_obs
from cartpoleplusplus_tpu_torch.models.networks import Actor
from cartpoleplusplus_tpu_torch.utils.params import actor_params_from_flax

torch.set_num_threads(2)

E = 16
STEPS = 3
# Config 5's shape (2 cameras, 50×50, obs_pool 2, obs_samples 2, 3 repeats
# × 5 substeps, 30-substep push) at 16 envs; episodes capped at 2 steps so
# the timeout and the sticky-done reward are exercised.
CFG_KW = dict(discrete_actions=False, use_raw_pixels=True, num_cameras=2, obs_pool=2,
              obs_samples=2, max_episode_len=2)


def _quantize(frames):
    """The kernels' uint8 convention, floor(clip(c·255 + 0.5, 0, 255))."""
    return jnp.clip(frames * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)


def _pixel_close(got, want):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert (diff <= 2).mean() > 0.999, f"{(diff > 2).mean():.4%} pixels off"
    assert diff.mean() < 0.5


@pytest.fixture(scope="module")
def rollouts():
    """(JAX, port) reset + STEPS steps on the same randoms and actions."""
    jcfg, cfg = JConfig(**CFG_KW), CartpoleConfig(**CFG_KW)
    key = jax.random.PRNGKey(7)
    k_theta, k_jitter = jax.random.split(key)  # as reset_batched splits it
    theta = jax.random.uniform(k_theta, (E,), minval=0.0, maxval=2.0 * jnp.pi)
    jitter = jax.random.normal(k_jitter, (E, 2))
    actions = np.random.default_rng(0).uniform(-1.0, 1.0, (STEPS, E, 2)).astype(np.float32)

    jscene = jcartpole.scene_for(jcfg)
    f32_observe = jmake_observe_pixels(jcfg, dtype=jnp.float32)
    observe = lambda s, r: _quantize(f32_observe(s, r))
    reset = jax.jit(lambda k: jcartpole.reset_batched(jcfg, jscene, k, E, observe_fn=observe))
    step = jax.jit(lambda st, a: jcartpole.step_batched(jcfg, jscene, st, a, observe_fn=observe))
    jstate, jobs = reset(key)
    jout = [(jstate.rigid, jobs, None, None)]
    for a in actions:
        jstate, jobs, jrew, jdone = step(jstate, jnp.asarray(a))
        jout.append((jstate.rigid, jobs, jrew, jdone))

    venv = make_venv(cfg, E, device="cpu")
    state, obs = venv.reset(theta=torch.tensor(np.asarray(theta)),
                            jitter=torch.tensor(np.asarray(jitter)))
    out = [(state.rigid, obs, None, None)]
    for a in actions:
        state, obs, rew, done = cartpole.step_batched(
            cfg, venv.scene, state, torch.from_numpy(a), venv.sim_fn)
        out.append((state.rigid, obs, rew, done))
    return jout, out


@pytest.mark.parametrize("t", range(STEPS + 1))
def test_slice_obs_match_jax(rollouts, t):
    jout, out = rollouts
    assert out[t][1].dtype == torch.uint8
    assert tuple(out[t][1].shape) == (E,) + CartpoleConfig(**CFG_KW).pixel_obs_shape
    _pixel_close(out[t][1].numpy(), jout[t][1])


# Physics after the push and after each step.  pos/quat/vel hold atol 1e-5
# as the per-call parity in test_torch_physics does.  Angular velocity gets
# 1e-4 + 1e-4 relative: the pole's inverse inertia about its long axis is
# 6e3 (a 0.1 kg, 0.1 m thick box), so float32 rounding differences of the
# contact impulses, compounded over up to 75 substeps, show up there first
# (measured 9.2e-5 on a 1.5 rad/s spin while pos/vel agree to 3e-6).
STATE_TOL = {"pos": (1e-5, 0.0), "quat": (1e-5, 0.0), "vel": (1e-5, 0.0), "ang": (1e-4, 1e-4)}


@pytest.mark.parametrize("t", range(STEPS + 1))
def test_slice_state_matches_jax(rollouts, t):
    jout, out = rollouts
    for field, (atol, rtol) in STATE_TOL.items():
        np.testing.assert_allclose(getattr(out[t][0], field).numpy(),
                                   np.asarray(getattr(jout[t][0], field)),
                                   atol=atol, rtol=rtol, err_msg=field)


@pytest.mark.parametrize("t", range(1, STEPS + 1))
def test_slice_reward_done_match_jax(rollouts, t):
    jout, out = rollouts
    np.testing.assert_array_equal(out[t][3].numpy(), np.asarray(jout[t][3]))
    np.testing.assert_array_equal(out[t][2].numpy(), np.asarray(jout[t][2]))


def test_slice_exercises_done(rollouts):
    """The capped episodes end at step 2 and then earn 0."""
    _, out = rollouts
    assert out[2][3].all() and out[3][3].all()
    assert (out[3][2] == 0).all()


def _flax_actor(use_raw_pixels):
    cfg = CartpoleConfig(**CFG_KW) if use_raw_pixels else CartpoleConfig(discrete_actions=False)
    jactor = JActor(action_dim=2, use_raw_pixels=use_raw_pixels,
                    height=cfg.obs_height, width=cfg.obs_width)
    dummy = jnp.zeros((2,) + cfg.obs_shape, jnp.float32)
    params = jax.tree.map(np.asarray, jactor.init(jax.random.PRNGKey(3), dummy))
    # Widen the ±3e-3 output head so actions span the tanh range and the
    # comparison is not of near-zero numbers.
    rng = np.random.default_rng(5)
    params["params"]["mu"]["kernel"] = rng.normal(0.0, 0.3, (50, 2)).astype(np.float32)
    params["params"]["mu"]["bias"] = rng.normal(0.0, 0.3, (2,)).astype(np.float32)
    return cfg, jactor, params


@pytest.mark.parametrize("use_raw_pixels", [True, False])
def test_actor_matches_flax(use_raw_pixels):
    """Greedy actions of the port's Actor against flax ``Actor.apply`` with
    the same weights.  Tolerance 2e-2 on actions in [-1, 1]: both encoders
    compute in bfloat16 (8-bit mantissa, ~4e-3 relative per rounding), and
    the two frameworks round the products and sums at different places."""
    cfg, jactor, params = _flax_actor(use_raw_pixels)
    rng = np.random.default_rng(11)
    if use_raw_pixels:
        obs = rng.integers(0, 256, (8,) + cfg.obs_shape, dtype=np.uint8)
    else:
        obs = rng.normal(0.0, 0.5, (8,) + cfg.obs_shape).astype(np.float32)
    want = np.asarray(jactor.apply(params, jnp.asarray(obs)))

    actor = Actor(cfg.obs_shape, use_raw_pixels=use_raw_pixels, height=cfg.obs_height,
                  width=cfg.obs_width, device="cpu")
    actor.load_state_dict(actor_params_from_flax(params), strict=True)
    got = greedy_act(actor)(torch.from_numpy(obs)).numpy()
    assert got.shape == want.shape == (8, 2)
    assert np.abs(want).max() > 0.3  # actions are not all near zero
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_params_conversion_layout():
    _, _, params = _flax_actor(True)
    sd = actor_params_from_flax(params["params"])
    emb = params["params"]["ObsEncoder_0"]["pixel_embed"]["kernel"]
    assert sd["encoder.pixel_embed.weight"].shape == (emb.shape[1], emb.shape[0])
    np.testing.assert_array_equal(sd["encoder.pixel_embed.weight"].numpy(), emb.T)
    assert set(sd) == {
        "encoder.pixel_embed.weight", "encoder.pixel_embed.bias",
        "encoder.trunk.hidden.0.weight", "encoder.trunk.hidden.0.bias",
        "encoder.trunk.hidden.1.weight", "encoder.trunk.hidden.1.bias",
        "mu.weight", "mu.bias",
    }


def test_pixel_pool_matches_flax():
    """The encoder's network-side pool (pixel_pool=2 on 50×50 frames)."""
    kw = dict(discrete_actions=False, use_raw_pixels=True, num_cameras=1, action_repeats=1)
    cfg = CartpoleConfig(**kw)
    jactor = JActor(action_dim=2, use_raw_pixels=True, pixel_pool=2)
    params = jax.tree.map(
        np.asarray, jactor.init(jax.random.PRNGKey(4), jnp.zeros((2,) + cfg.obs_shape)))
    obs = np.random.default_rng(6).integers(0, 256, (4,) + cfg.obs_shape, dtype=np.uint8)
    want = np.asarray(jactor.apply(params, jnp.asarray(obs)))
    actor = Actor(cfg.obs_shape, use_raw_pixels=True, pixel_pool=2, device="cpu")
    actor.load_state_dict(actor_params_from_flax(params))
    np.testing.assert_allclose(greedy_act(actor)(torch.from_numpy(obs)).numpy(), want,
                               atol=2e-2, rtol=0)


def test_eval_rollout_cpu():
    cfg = CartpoleConfig(**{**CFG_KW, "max_episode_len": 3})
    venv = make_venv(cfg, 4, device="cpu")
    actor = Actor(cfg.obs_shape, use_raw_pixels=True, height=cfg.obs_height,
                  width=cfg.obs_width, device="cpu", generator=torch.Generator().manual_seed(0))
    mean_len, mean_rew = eval_rollout(venv, greedy_act(actor), torch.Generator().manual_seed(1))
    assert math.isfinite(float(mean_len)) and math.isfinite(float(mean_rew))
    assert 1.0 <= float(mean_len) <= 3.0
    assert float(mean_rew) <= float(mean_len)


def test_vector_auto_reset():
    """step and step_lazy + resolve_obs agree, and done envs carry the pool."""
    cfg = CartpoleConfig(**{**CFG_KW, "max_episode_len": 1})
    venv = make_venv(cfg, 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    state, obs = venv.reset(g)
    pool = venv.reset(g)
    action = torch.zeros((4, 2))
    carried, obs2, rew, done, next_obs = venv.step(state, action, reset_pool=pool)
    lazy, obs3, rew3, done3 = venv.step_lazy(state, action, reset_pool=pool)
    assert done.all()
    assert torch.equal(obs2, obs3) and torch.equal(rew, rew3) and torch.equal(done, done3)
    assert torch.equal(next_obs, resolve_obs(done, pool[1], obs3))
    assert torch.equal(next_obs, pool[1])
    assert torch.equal(carried.rigid.pos, pool[0].rigid.pos)
    assert torch.equal(lazy.steps, pool[0].steps)


def test_reset_draws_from_generator():
    cfg = CartpoleConfig(**CFG_KW)
    venv = make_venv(cfg, 4, device="cpu")
    a = venv.reset(torch.Generator().manual_seed(0))[0].rigid.pos
    b = venv.reset(torch.Generator().manual_seed(0))[0].rigid.pos
    c = venv.reset(torch.Generator().manual_seed(1))[0].rigid.pos
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        venv.reset()

"""The port's discrete-action env against the JAX package on the CPU, the
branch LRPG acts through: ``step_batched`` with each of the 5 actions
(the nop/±x/±y force table) under every ``--reward-calc`` mode, low-dim
and pixels (the slab and the raster plain versions, through
``make_venv``'s wiring), fed JAX's states call by call; and a greedy
``eval_rollout`` of an integer argmax policy from JAX's reset draws.

Tolerances: physics as tests/test_torch_slice.py holds it (atol 1e-5;
angular velocity 1e-4 + 1e-4 relative); pixels |Δ| ≤ 2 levels on ≥ 99.9 %
of values, mean < 0.5; rewards and dones equal (the angle modes' cos of
the tilt within 1e-6 of JAX's, one float32 rounding of a state within the
physics tolerance); the eval's episode lengths and returns equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.env import cartpole as jcartpole
from cartpoleplusplus_tpu.render import make_observe_pixels as jmake_observe_pixels
from cartpoleplusplus_tpu_torch.agents.common import eval_rollout, make_venv
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import DISCRETE_ACTIONS, REWARD_CALCS, CartpoleConfig
from cartpoleplusplus_tpu_torch.env.vector import VectorCartpole
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState

torch.set_num_threads(2)

E = 10  # each of the 5 actions on 2 envs
STEPS = 3
STATE_TOL = {"pos": (1e-5, 0.0), "quat": (1e-5, 0.0), "vel": (1e-5, 0.0), "ang": (1e-4, 1e-4)}
# Episodes capped at 2 steps: the timeout and the sticky-done zero reward.
CASES = {
    "lowdim": dict(use_raw_pixels=False),
    "slab": dict(use_raw_pixels=True, num_cameras=2, obs_pool=2, obs_samples=2),
    "raster": dict(use_raw_pixels=True, num_cameras=1, obs_pool=2, obs_samples=0),
}


def _cfg_kw(case, reward_calc):
    return dict(discrete_actions=True, max_episode_len=2, reward_calc=reward_calc, **CASES[case])


def _quantize(frames):
    """The kernels' uint8 convention, floor(clip(c·255 + 0.5, 0, 255))."""
    return jnp.clip(frames * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)


def _torch_state(js):
    return EnvState(rigid=RigidState(**{f: torch.tensor(np.asarray(getattr(js.rigid, f)))
                                        for f in ("pos", "quat", "vel", "ang")}),
                    steps=torch.tensor(np.asarray(js.steps)),
                    done=torch.tensor(np.asarray(js.done)))


def _observe(jcfg):
    if not jcfg.use_raw_pixels:
        return {}
    f32 = jmake_observe_pixels(jcfg, dtype=jnp.float32, raster=jcfg.obs_samples == 0)
    return dict(observe_fn=lambda s, r: _quantize(f32(s, r)))


@functools.lru_cache(maxsize=None)
def _reset(case):
    """JAX's reset state of ``case`` (the reward mode plays no part in it)."""
    jcfg = JConfig(**_cfg_kw(case, "fixed"))
    jscene = jcartpole.scene_for(jcfg)
    return jax.jit(lambda k: jcartpole.reset_batched(jcfg, jscene, k, E, **_observe(jcfg)))(
        jax.random.PRNGKey(5))[0]


@functools.lru_cache(maxsize=None)
def _steps(case, reward_calc):
    """JAX's STEPS steps of the actions ``arange(E) % 5`` from its reset,
    and the port's step_batched fed JAX's state before each step."""
    jcfg, cfg = JConfig(**_cfg_kw(case, reward_calc)), CartpoleConfig(**_cfg_kw(case, reward_calc))
    jscene = jcartpole.scene_for(jcfg)
    observe = _observe(jcfg)
    step = jax.jit(lambda st, a: jcartpole.step_batched(jcfg, jscene, st, a, **observe))
    action = np.arange(E) % len(DISCRETE_ACTIONS)
    jstate = _reset(case)
    venv = make_venv(cfg, E, device="cpu")
    pairs = []
    for _ in range(STEPS):
        fed = _torch_state(jstate)
        got = cartpole.step_batched(cfg, venv.scene, fed, torch.from_numpy(action), venv.sim_fn)
        jstate, jobs, jrew, jdone = step(jstate, jnp.asarray(action))
        pairs.append((got, (jstate, jobs, jrew, jdone)))
    return pairs


@pytest.mark.parametrize("reward_calc", REWARD_CALCS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_discrete_step_matches_jax(case, reward_calc):
    for t, ((state, obs, rew, done), (jstate, jobs, jrew, jdone)) in enumerate(
            _steps(case, reward_calc)):
        for field, (atol, rtol) in STATE_TOL.items():
            np.testing.assert_allclose(getattr(state.rigid, field).numpy(),
                                       np.asarray(getattr(jstate.rigid, field)), atol=atol,
                                       rtol=rtol, err_msg=f"{field} step {t}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        if reward_calc in ("angle", "angle_action"):
            np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        if CASES[case]["use_raw_pixels"]:
            assert obs.dtype == torch.uint8
            diff = np.abs(obs.numpy().astype(np.int32) - np.asarray(jobs, np.int32))
            assert (diff <= 2).mean() >= 0.999 and diff.mean() < 0.5
        else:
            np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-5)
    # Timeout at step 2, then zero reward while done.
    assert bool(done.all()) and float(rew.abs().max()) == 0.0


@pytest.mark.parametrize("reward_calc", REWARD_CALCS)
def test_discrete_force_and_reward_branches(reward_calc):
    """Each action index pushes along its table row at ``action_force``;
    the action penalty counts a non-nop action as magnitude 1."""
    cfg = CartpoleConfig(**_cfg_kw("lowdim", reward_calc))
    action = torch.arange(E) % len(DISCRETE_ACTIONS)
    force = cartpole.action_to_force(cfg, action)
    want = cfg.action_force * torch.tensor(DISCRETE_ACTIONS)[action]
    assert torch.equal(force[:, :2], want) and float(force[:, 2].abs().max()) == 0.0
    (_, _, rew, _), _ = _steps("lowdim", reward_calc)[0]
    (_, _, fixed, _), _ = _steps("lowdim", "fixed")[0]
    nop = action == 0
    if reward_calc == "action":
        assert torch.equal(rew[nop], fixed[nop]) and torch.allclose(rew[~nop], fixed[~nop] - 0.1)
    elif reward_calc == "fixed":
        assert torch.equal(rew, torch.ones(E))


def _table_policy(scores: torch.Tensor):
    """An integer argmax policy: obs (n, …) → argmax of row i of
    ``scores`` for env i, whatever the obs (a free-running float32
    trajectory parts from JAX's at a grazing contact within a few hundred
    substeps, tests/test_torch_lowdim.py; a policy that read the state
    would carry such a parting into its actions)."""

    def act(obs: torch.Tensor) -> torch.Tensor:
        return torch.argmax(scores.to(obs.device), dim=-1)

    return act


def test_eval_rollout_lengths_match_jax():
    """``eval_rollout`` of an argmax policy over seeded scores, every action
    on some env, from JAX's reset draws: the mean episode length and return
    equal JAX's eval_rollout of the same policy, episodes ending before the
    cap."""
    kw = dict(discrete_actions=True, use_raw_pixels=False, max_episode_len=60)
    jcfg, cfg = JConfig(**kw), CartpoleConfig(**kw)
    n = 16
    scores = np.random.default_rng(6).normal(size=(n, len(DISCRETE_ACTIONS))).astype(np.float32)
    assert set(np.argmax(scores, axis=-1)) == set(range(len(DISCRETE_ACTIONS)))
    jvenv = jcommon.make_venv(jcfg, n)
    key = jax.random.PRNGKey(4)
    jact = lambda params, obs: jnp.argmax(jnp.asarray(scores), axis=-1)
    jlen, jrew = jax.jit(lambda k: jcommon.eval_rollout(jvenv, jact, None, k))(key)
    k_theta, k_jitter = jax.random.split(key)
    theta = torch.tensor(np.asarray(jax.random.uniform(k_theta, (n,), minval=0.0,
                                                       maxval=2.0 * jnp.pi)))
    jitter = torch.tensor(np.asarray(jax.random.normal(k_jitter, (n, 2))))
    venv = make_venv(cfg, n, device="cpu")
    venv.reset = lambda generator: VectorCartpole.reset(venv, None, theta, jitter)
    elen, erew = eval_rollout(venv, _table_policy(torch.from_numpy(scores)), torch.Generator())
    assert 2.0 < float(jlen) < 60.0
    assert float(elen) == float(jlen)
    assert float(erew) == pytest.approx(float(jrew), rel=1e-6)

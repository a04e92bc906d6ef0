"""The port's data parallelism (``cartpoleplusplus_tpu_torch/parallel``) on
the CPU, on gloo ranks, at the sizes of ``tests/test_parallel.py`` (its
``CFG``, 16 global envs, replay capacity 256).

Against the JAX package, whose side runs under ``jax.shard_map`` on 2 of
the test process's 8 virtual CPU devices while the port's runs on 2 gloo
ranks, each fed its shard's batch and the draws JAX's chip of the same
index makes from its key:
- one TD3 update (``test_torch_ddpg.py``'s TD3 case), held to that file's
  bounds: every parameter within 2·lr (+1e-6) of JAX's, at most 1e-4 of a
  network's entries beyond lr;
- one PPO update (``test_torch_ppo.py``'s shape at 16 envs), its params
  within that file's ``PARAM_LR_BOUND``·lr;
- the σ = 0, gated-out DDPG segment of ``test_parallel.py:126`` from the
  JAX run's own start: env positions at atol 1e-6;
- ``test_sharded_sim_matches_global``'s counterpart: 16 envs stepped at
  once equal 8 shards of 2 stepped alone, and JAX's step of the same states.

Within the port: a 1-rank group reproduces the plain segment byte for
byte; after 3 segments on 2 ranks the params and optimizer states are
byte-equal across ranks, the params moved, the env shards differ, and the
replay cursor counts one shard's rows; ``state_specs`` with ``priority``
None; a rank that fails or outlives its time limit fails the run.

The ranks run module-level functions of this file, which therefore
imports no JAX at module level (a spawned rank imports it by name).
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu_torch import parallel
from cartpoleplusplus_tpu_torch.agents import common, ddpg, ppo
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig, config_from_opts
from cartpoleplusplus_tpu_torch.models.networks import (
    Actor, GaussianActor, TwinCritic, ValueNetwork)
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.parallel.mesh import free_port
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.replay.buffer import ReplayState

torch.set_num_threads(2)

CFG_KW = dict(discrete_actions=False, action_repeats=2, steps_per_repeat=2,
              initial_force_steps=4, max_episode_len=20)
CFG = CartpoleConfig(**CFG_KW)
N_RANKS = 2
GLOBAL_ENVS = 16
CAPACITY = 256
NET = dict(hidden=(16, 16))
SEG_KW = dict(gamma=0.99, tau=0.005, batch_size=8, warmup_steps=2, steps_per_segment=4,
              ou_theta=0.15, ou_sigma=0.2)
SIGMA0_KW = dict(gamma=0.99, tau=0.005, batch_size=8, warmup_steps=100, steps_per_segment=3,
                 ou_theta=0.15, ou_sigma=0.0)
# test_torch_ddpg.py's TD3 case on its 1-camera exact frames.
TD3_CFG_KW = dict(discrete_actions=False, use_raw_pixels=True, num_cameras=1, obs_pool=2,
                  obs_samples=0)
TD3_HP = dict(twin_critic=True, policy_delay=2, target_noise=0.2, target_noise_clip=0.5,
              aug_shift=2, reward_scale=0.1, grad_clip=1.0)
TD3_HIDDEN = (32, 16)
B = 16  # per-shard batch
LR_A, LR_C = 1e-4, 1e-3
# test_torch_ppo.py's update at 16 global envs.
PPO_LR = 1e-3
PPO_ARGV = ["--num-envs", str(GLOBAL_ENVS), "--rollout-steps", "8", "--ppo-epochs", "2",
            "--ppo-minibatches", "2", "--max-episode-len", "5", "--hidden", "16", "16",
            "--learning-rate", str(PPO_LR), "--reward-scale", "0.1", "--seed", "3"]
PPO_PARAM_LR_BOUND = 0.2


def _t(x):
    return torch.from_numpy(np.array(x))


def _cpu(sd):
    if isinstance(sd, dict):
        return {k: _cpu(v) for k, v in sd.items()}
    return sd.detach().cpu().clone() if torch.is_tensor(sd) else sd


def _bytes_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _bytes_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_bytes_equal(x, y) for x, y in zip(a, b))
    return a == b


def _global_state(num_devices: int):
    return parallel.global_ddpg_state(CFG, GLOBAL_ENVS, CAPACITY, seed=0,
                                      num_devices=num_devices, device="cpu", **NET)


def _env_state(arrays: dict) -> EnvState:
    return EnvState(rigid=RigidState(**{f: _t(arrays[f]) for f in ("pos", "quat", "vel", "ang")}),
                    steps=_t(arrays["steps"]), done=_t(arrays["done"]))


# ---------------------------------------------------------------------------
# The ranks' work (module level: a spawned rank imports it by name)
# ---------------------------------------------------------------------------


def _segments(mesh, segments: int) -> dict:
    """``segments`` distributed DDPG segments from the global state."""
    st = _global_state(mesh.world)
    before = _cpu(st.actor.state_dict())
    venv = common.make_venv(CFG, GLOBAL_ENVS // mesh.world, device="cpu")
    segment, shard = parallel.make_distributed_segment(mesh, venv, **SEG_KW)
    shard(st)
    for _ in range(segments):
        metrics = segment(st)
    return dict(before=before, nets={k: _cpu(getattr(st, k).state_dict())
                                     for k in ("actor", "critic", "target_actor",
                                               "target_critic", "actor_opt", "critic_opt")},
                pos=_cpu(st.env_states.rigid.pos), cursor=st.replay.cursor,
                size=st.replay.size, env_steps=st.env_steps, reward=float(metrics["reward"]))


def _sigma0(mesh, start: dict) -> dict:
    """The σ = 0, gated-out segment from the JAX run's global start."""
    st = _global_state(mesh.world)
    st.env_states, st.obs = _env_state(start["env"]), _t(start["obs"])
    st.actor.load_state_dict(start["actor"])
    venv = common.make_venv(CFG, GLOBAL_ENVS // mesh.world, device="cpu")
    segment, shard = parallel.make_distributed_segment(mesh, venv, **SIGMA0_KW)
    shard(st)
    segment(st)
    return dict(pos=_cpu(st.env_states.rigid.pos))


def _td3_update(mesh, start: dict) -> dict:
    """One TD3 train_once on this rank's batch and draws."""
    cfg = CartpoleConfig(**TD3_CFG_KW)
    kw = dict(use_raw_pixels=True, hidden=TD3_HIDDEN, height=cfg.obs_height,
              width=cfg.obs_width, device="cpu")
    actor, critic = Actor(cfg.obs_shape, **kw), TwinCritic(cfg.obs_shape, **kw)
    actor.load_state_dict(start["actor"])
    critic.load_state_dict(start["critic"])
    actor_opt, actor_sched = ddpg.adam(actor, LR_A)
    critic_opt, critic_sched = ddpg.adam(critic, LR_C)
    st = ddpg.DDPGState(
        actor=actor, critic=critic, target_actor=copy.deepcopy(actor).requires_grad_(False),
        target_critic=copy.deepcopy(critic).requires_grad_(False), actor_opt=actor_opt,
        critic_opt=critic_opt, actor_sched=actor_sched, critic_sched=critic_sched, replay=None,
        env_states=None, obs=None, ou_noise=None, generator=torch.Generator().manual_seed(0))
    once = ddpg.make_train_once(cfg, gamma=0.99, tau=0.005, warmup_steps=0, group=mesh.group,
                                **TD3_HP)
    offsets, eps = start["draws"][mesh.rank]
    once(st, tuple(torch.from_numpy(x) for x in start["batches"][mesh.rank]), 1,
         aug_offsets=offsets, target_eps=eps)
    return dict(actor=_cpu(st.actor.state_dict()), critic=_cpu(st.critic.state_dict()))


def _ppo_update(mesh, start: dict) -> dict:
    """One distributed PPO update on this rank's env rows and draws."""
    opts = ppo.make_parser().parse_args(PPO_ARGV)
    cfg = config_from_opts(opts, discrete_actions=False)
    e = GLOBAL_ENVS // mesh.world
    venv = common.make_venv(cfg, e, device="cpu")
    kw = dict(use_raw_pixels=False, hidden=(16, 16), device="cpu")
    actor, value = GaussianActor(cfg.obs_shape, **kw), ValueNetwork(cfg.obs_shape, **kw)
    actor.load_state_dict(start["actor"])
    value.load_state_dict(start["value"])
    opt, sched = ddpg.adam(torch.nn.ModuleList([actor, value]), PPO_LR)
    rows = slice(mesh.rank * e, (mesh.rank + 1) * e)
    env = {k: np.asarray(v)[rows] for k, v in start["env"].items()}
    st = ppo.PPOState(actor=actor, value=value, opt=opt, sched=sched, env_states=_env_state(env),
                      obs=_t(np.asarray(start["obs"])[rows]),
                      generator=torch.Generator().manual_seed(0))
    step, _ = parallel.make_distributed(mesh, ppo.make_train_step(venv, opts, group=mesh.group),
                                        ppo.SHARDED_FIELDS, ppo.METRIC_KEYS)
    step(st, **start["draws"][mesh.rank])
    return dict(actor=_cpu(st.actor.state_dict()), value=_cpu(st.value.state_dict()))


def _fail_on_rank_1(mesh) -> int:
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    return mesh.rank


def _sleep(mesh, seconds: float) -> int:
    import time

    time.sleep(seconds)
    return mesh.rank


def _rank_work(mesh, jax_start: dict) -> dict:
    """Everything the 2-rank tests need, in one spawn of the ranks."""
    return dict(segments=_segments(mesh, 3), sigma0=_sigma0(mesh, jax_start["sigma0"]),
                td3=_td3_update(mesh, jax_start["td3"]), ppo=_ppo_update(mesh, jax_start["ppo"]))


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _jax_sigma0():
    """JAX's own 2-device σ = 0 segment (test_parallel.py:126) → its start
    for the port and its end positions."""
    import jax
    import optax

    from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
    from cartpoleplusplus_tpu.env import VectorCartpole as JVector
    from cartpoleplusplus_tpu.models import Actor as JActor
    from cartpoleplusplus_tpu.models import Critic as JCritic
    from cartpoleplusplus_tpu.parallel import global_ddpg_state, make_distributed_segment, make_mesh
    from cartpoleplusplus_tpu_torch.utils.params import actor_params_from_flax

    actor, critic = JActor(action_dim=2, **NET), JCritic(**NET)
    tx = optax.adam(1e-3)
    st0 = jax.device_get(global_ddpg_state(JConfig(**CFG_KW), GLOBAL_ENVS, CAPACITY, actor, critic,
                                           tx, tx, num_devices=N_RANKS))
    build, shard = make_distributed_segment(make_mesh(N_RANKS),
                                            JVector(JConfig(**CFG_KW), GLOBAL_ENVS // N_RANKS),
                                            actor, critic, tx, tx, **SIGMA0_KW)
    r = st0.env_states.rigid
    start = dict(env={**{f: np.array(getattr(r, f)) for f in ("pos", "quat", "vel", "ang")},
                      "steps": np.array(st0.env_states.steps),
                      "done": np.array(st0.env_states.done)},
                 obs=np.array(st0.obs), actor=actor_params_from_flax(st0.actor_params))
    st = shard(jax.tree.map(np.array, st0))
    st, _ = build(st)(st)
    return start, np.asarray(st.env_states.rigid.pos)


def _jax_td3():
    """JAX's TD3 train_once (from make_segment's closure, with
    ``axis_name``) under shard_map on 2 devices, each on its batch and key
    → the port's start (params, batches, each shard's draws) and JAX's new
    bundle."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    from cartpoleplusplus_tpu.agents import common as jcommon
    from cartpoleplusplus_tpu.agents import ddpg as jddpg
    from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
    from cartpoleplusplus_tpu.models import Actor as JActor
    from cartpoleplusplus_tpu.models import Critic as JCritic
    from cartpoleplusplus_tpu.parallel import make_mesh
    from cartpoleplusplus_tpu_torch.utils.params import (
        actor_params_from_flax, critic_params_from_flax)

    jcfg = JConfig(**TD3_CFG_KW)
    kw = dict(use_raw_pixels=True, hidden=TD3_HIDDEN, height=jcfg.obs_height,
              width=jcfg.obs_width)
    jactor, jcritic = JActor(action_dim=2, **kw), JCritic(**kw)
    k_a, k_c, k_train = jax.random.split(jax.random.PRNGKey(11), 3)
    dummy = (jnp.zeros((2,) + jcfg.obs_shape), jnp.zeros((2, 2)))
    actor_vars = dict(jactor.init(k_a, dummy[0]))
    critic_vars = jax.vmap(lambda k: dict(jcritic.init(k, *dummy)))(jax.random.split(k_c, 2))
    tx = lambda lr: optax.chain(optax.clip_by_global_norm(TD3_HP["grad_clip"]), optax.adam(lr))
    atx, ctx = tx(LR_A), tx(LR_C)
    jhp = {k: v for k, v in TD3_HP.items() if k != "grad_clip"}
    seg = jddpg.make_segment(jcommon.make_venv(jcfg, 4), jactor, jcritic, atx, ctx, gamma=0.99,
                             tau=0.005, batch_size=B, warmup_steps=0, steps_per_segment=1,
                             ou_theta=0.15, ou_sigma=0.2, axis_name="env", **jhp)
    train_once = _closure(seg)["train_once"]
    bundle = (actor_vars, critic_vars, actor_vars, critic_vars,
              atx.init(actor_vars["params"]), ctx.init(critic_vars["params"]))
    rng = np.random.default_rng(0)
    shape = (B, *jcfg.obs_shape)
    batches = [(rng.integers(0, 256, shape, dtype=np.uint8),
                rng.uniform(-1, 1, (B, 2)).astype(np.float32),
                rng.normal(size=B).astype(np.float32),
                rng.integers(0, 256, shape, dtype=np.uint8), rng.random(B) < 0.25)
               for _ in range(N_RANKS)]
    keys = jax.random.split(k_train, N_RANKS)

    def per_chip(bundle, batch, iw, keys, step):
        return train_once(bundle, batch, iw, keys[0], step)[0]

    mapped = jax.shard_map(per_chip, mesh=make_mesh(N_RANKS),
                           in_specs=(P(), P("env"), P("env"), P("env"), P()), out_specs=P(),
                           check_vma=False)
    gbatch = tuple(jnp.concatenate([jnp.asarray(b[i]) for b in batches]) for i in range(5))
    new_bundle = jax.jit(mapped)(bundle, gbatch, jnp.ones((N_RANKS * B,), jnp.float32), keys,
                                 jnp.asarray(1, jnp.int32))

    def draws(key):  # the draws a train_once makes from its key
        k_aug, k_tn = jax.random.split(key)
        k1, k2 = jax.random.split(k_aug)
        pad = TD3_HP["aug_shift"]
        offsets = tuple(_t(jax.random.randint(k, (B, 2), 0, 2 * pad + 1)) for k in (k1, k2))
        return offsets, _t(jax.random.normal(k_tn, (B, 2)))

    start = dict(actor=actor_params_from_flax(jax.device_get(actor_vars)),
                 critic=critic_params_from_flax(jax.device_get(critic_vars)),
                 batches=batches, draws=[draws(k) for k in keys])
    return start, dict(actor=actor_params_from_flax(jax.device_get(new_bundle[0])),
                       critic=critic_params_from_flax(jax.device_get(new_bundle[1])))


def _jax_ppo():
    """JAX's PPO train_step with ``axis_name`` under the JAX package's
    ``make_distributed`` on 2 devices → the port's start (params, the
    global env states and obs, each chip's draws from its folded key) and
    JAX's new params."""
    import jax
    import jax.numpy as jnp
    import optax

    from cartpoleplusplus_tpu.agents import common as jcommon
    from cartpoleplusplus_tpu.agents import ppo as jppo
    from cartpoleplusplus_tpu.env.config import config_from_opts as jconfig_from_opts
    from cartpoleplusplus_tpu.models import GaussianActor as JGaussianActor
    from cartpoleplusplus_tpu.models import ValueNetwork as JValueNetwork
    from cartpoleplusplus_tpu.parallel import make_distributed, make_mesh
    from cartpoleplusplus_tpu_torch.utils.params import (
        gaussian_actor_params_from_flax, value_params_from_flax)

    parser = jcommon.make_parser("t")
    jppo.add_ppo_opts(parser)
    opts = parser.parse_args(PPO_ARGV)
    jcfg = jconfig_from_opts(opts, discrete_actions=False)
    kw = dict(use_raw_pixels=False, hidden=(16, 16))
    jactor, jvalue = JGaussianActor(action_dim=2, **kw), JValueNetwork(**kw)
    k_a, k_v, k_env, rng = jax.random.split(jax.random.PRNGKey(11), 4)
    dummy = jnp.zeros((1,) + jcfg.obs_shape)
    params = {"actor": jactor.init(k_a, dummy), "value": jvalue.init(k_v, dummy)}
    tx = optax.chain(optax.clip_by_global_norm(opts.grad_clip), optax.adam(PPO_LR))
    env_states, obs = jcommon.make_venv(jcfg, GLOBAL_ENVS).reset(k_env)
    ps = jax.device_get(jppo.PPOState(params=params, opt_state=tx.init(params),
                                      env_states=env_states, obs=obs, rng=rng,
                                      update=jnp.zeros((), jnp.int32)))
    e = GLOBAL_ENVS // N_RANKS
    per_chip = jppo.make_train_step(jcommon.make_venv(jcfg, e), jactor, jvalue, tx, opts,
                                    axis_name="env")
    step, shard = make_distributed(make_mesh(N_RANKS), per_chip, ps, jppo.PPO_SHARDED_FIELDS,
                                   jppo.PPO_METRIC_KEYS)
    new_ps, _ = step(shard(jax.tree.map(np.array, ps)))

    T, K = opts.rollout_steps, opts.ppo_epochs

    def draws(chip):  # train_step's draws from its folded key, split as it splits them
        _, k_reset, k_roll, k_perm = jax.random.split(jax.random.fold_in(rng, chip), 4)
        k_theta, k_jitter = jax.random.split(k_reset)
        return dict(
            eps=_t(jnp.stack([jax.random.normal(k, (e, 2))
                              for k in jax.random.split(k_roll, T)])),
            perms=_t(jnp.stack([jax.random.permutation(k, T * e)
                                for k in jax.random.split(k_perm, K)])).long(),
            reset=(_t(jax.random.uniform(k_theta, (e,), minval=0.0, maxval=2.0 * jnp.pi)),
                   _t(jax.random.normal(k_jitter, (e, 2)))))

    r = ps.env_states.rigid
    start = dict(actor=gaussian_actor_params_from_flax(ps.params["actor"]),
                 value=value_params_from_flax(ps.params["value"]),
                 env={**{f: np.array(getattr(r, f)) for f in ("pos", "quat", "vel", "ang")},
                      "steps": np.array(ps.env_states.steps), "done": np.array(ps.env_states.done)},
                 obs=np.array(ps.obs), draws=[draws(c) for c in range(N_RANKS)])
    new = jax.device_get(new_ps.params)
    return start, dict(actor=gaussian_actor_params_from_flax(new["actor"]),
                       value=value_params_from_flax(new["value"]))


@pytest.fixture(scope="module")
def two_ranks():
    """JAX's references first, then one spawn of 2 gloo ranks for all the
    2-rank tests."""
    sigma0_start, sigma0_pos = _jax_sigma0()
    td3_start, td3_want = _jax_td3()
    ppo_start, ppo_want = _jax_ppo()
    ranks = parallel.run_ranks(N_RANKS, _rank_work, dict(sigma0=sigma0_start, td3=td3_start,
                                                         ppo=ppo_start), timeout_s=300)
    return SimpleNamespace(ranks=ranks, sigma0_pos=sigma0_pos, td3_want=td3_want,
                           ppo_want=ppo_want)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def test_td3_update_matches_jax_shard_map(two_ranks):
    for net, lr in (("actor", LR_A), ("critic", LR_C)):
        got = [r["td3"][net] for r in two_ranks.ranks]
        assert _bytes_equal(got[0], got[1]), f"{net} differs across ranks"
        want = two_ranks.td3_want[net]
        flipped = total = 0
        for k, v in got[0].items():
            gap = (v - want[k]).abs()
            assert float(gap.max()) <= 2 * lr + 1e-6, f"{net}.{k}: {float(gap.max()):.3g}"
            flipped += int((gap > lr).sum())
            total += gap.numel()
        assert flipped / total <= 1e-4, f"{net}: {flipped} of {total} beyond lr"


def test_ppo_update_matches_jax_shard_map(two_ranks):
    for net in ("actor", "value"):
        got = [r["ppo"][net] for r in two_ranks.ranks]
        assert _bytes_equal(got[0], got[1]), f"{net} differs across ranks"
        want = two_ranks.ppo_want[net]
        gap = max(float((v - want[k]).abs().max()) / PPO_LR for k, v in got[0].items())
        print(f"ppo {net}: largest gap {gap:.3f} lr")
        assert gap <= PPO_PARAM_LR_BOUND, (net, gap)


def test_sigma0_segment_matches_jax(two_ranks):
    """test_parallel.py:126 on 2 ranks: with σ = 0 and training gated out,
    the ranks' env shards, in rank order, are JAX's 2-device run."""
    pos = torch.cat([r["sigma0"]["pos"] for r in two_ranks.ranks]).numpy()
    np.testing.assert_allclose(pos, two_ranks.sigma0_pos, rtol=0, atol=1e-6)


def test_sharded_sim_matches_global():
    """Envs are independent: 16 stepped in one batch equal 8 shards of 2
    stepped alone (the port), and JAX's batch from the same states."""
    import jax.numpy as jnp

    from cartpoleplusplus_tpu.env import VectorCartpole as JVector
    from cartpoleplusplus_tpu.env import cartpole as jcartpole
    from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig

    venv = common.make_venv(CFG, GLOBAL_ENVS, device="cpu")
    states, _ = venv.reset(torch.Generator().manual_seed(3))
    action = torch.rand((GLOBAL_ENVS, 2), generator=torch.Generator().manual_seed(4)) * 2 - 1
    g_states, _, g_rew, _ = cartpole.step_batched(CFG, venv.scene, states, action, venv.sim_fn)
    for s in range(8):
        sl = slice(2 * s, 2 * s + 2)
        part = EnvState(rigid=states.rigid.map(lambda x: x[sl]), steps=states.steps[sl],
                        done=states.done[sl])
        s_states, _, s_rew, _ = cartpole.step_batched(CFG, venv.scene, part, action[sl],
                                                      venv.sim_fn)
        torch.testing.assert_close(s_states.rigid.pos, g_states.rigid.pos[sl], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(s_rew, g_rew[sl], rtol=0, atol=1e-6)
    jvenv = JVector(JConfig(**CFG_KW), num_envs=GLOBAL_ENVS)
    from cartpoleplusplus_tpu.env.cartpole import EnvState as JEnvState
    from cartpoleplusplus_tpu.physics.bodies import RigidState as JRigid

    r = states.rigid
    jstates = JEnvState(rigid=JRigid(**{f: jnp.asarray(getattr(r, f).numpy())
                                        for f in ("pos", "quat", "vel", "ang")}),
                        steps=jnp.asarray(states.steps.numpy()),
                        done=jnp.asarray(states.done.numpy()))
    j_states, _, j_rew, _ = jcartpole.step_batched(JConfig(**CFG_KW), jvenv.scene, jstates,
                                                   jnp.asarray(action.numpy()), None)
    np.testing.assert_allclose(g_states.rigid.pos.numpy(), np.asarray(j_states.rigid.pos),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(g_rew.numpy(), np.asarray(j_rew), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------------


def test_two_ranks_stay_replicated(two_ranks):
    """After 3 segments: params and both optimizers byte-equal across ranks,
    the params moved, the env shards apart, training happened."""
    a, b = (r["segments"] for r in two_ranks.ranks)
    assert _bytes_equal(a["nets"], b["nets"])
    assert not _bytes_equal(a["nets"]["actor"], a["before"]), "params should have moved"
    assert not torch.allclose(a["pos"], b["pos"]), "env shards must evolve independently"
    assert a["reward"] > 0.0 and a["env_steps"] == b["env_steps"] == 12


def test_replay_cursor_is_per_shard(two_ranks):
    """Every shard writes its own 8 rows a step into its 128-row ring."""
    local_envs, local_cap = GLOBAL_ENVS // N_RANKS, CAPACITY // N_RANKS
    for r in two_ranks.ranks:
        assert r["segments"]["cursor"] == local_envs * 12 % local_cap
        assert r["segments"]["size"] == min(local_envs * 12, local_cap)


def test_one_rank_group_equals_plain_segment():
    """A 1-rank gloo group (in this process) reproduces the plain segment
    byte for byte: the whole state and the metrics."""
    plain = _global_state(1)
    seg = ddpg.make_segment(common.make_venv(CFG, GLOBAL_ENVS, device="cpu"), **SEG_KW)
    want = [seg(plain) for _ in range(2)]
    mesh = parallel.init_process_group(f"localhost:{free_port()}", 0, 1, device="cpu")
    try:
        assert mesh.backend == "gloo" and parallel.current_mesh() is mesh
        st = _global_state(1)
        venv = common.make_venv(CFG, GLOBAL_ENVS, device="cpu")
        segment, shard = parallel.make_distributed_segment(mesh, venv, **SEG_KW)
        shard(st)
        got = [segment(st) for _ in range(2)]
    finally:
        parallel.destroy()
    assert parallel.current_mesh() is None
    assert _bytes_equal(_cpu(st.state_dict()), _cpu(plain.state_dict()))
    for g, w in zip(got, want):
        assert _bytes_equal(_cpu(g), _cpu(w))


def test_state_specs_tolerates_priority_none():
    """A hand-built replay without priorities: the spec is None there too,
    so the spec tree has the state dict's shape; the replay's rows shard,
    its cursor and the networks replicate."""
    rs = ReplayState(s1=torch.zeros((8, 3)), action=torch.zeros((8, 2)), reward=torch.zeros(8),
                     s2=torch.zeros((0,)), terminal=torch.zeros(8, dtype=torch.bool),
                     priority=None, block=4)
    sd = {"replay": {f: getattr(rs, f) for f in ("s1", "action", "reward", "s2", "terminal",
                                                  "priority", "cursor", "size", "block")},
          "params": {"w": torch.zeros((4, 4))}, "obs": torch.zeros((8, 3))}
    specs = parallel.state_specs(sd, ("replay", "obs"))
    assert specs["replay"] == {"s1": "shard", "action": "shard", "reward": "shard",
                               "s2": "replicate", "terminal": "shard", "priority": None,
                               "cursor": "replicate", "size": "replicate", "block": "replicate"}
    assert specs["params"] == {"w": "replicate"} and specs["obs"] == "shard"
    # Names decide: a field not named stays whole whatever its shape.
    assert distributed.state_specs({"obs": torch.zeros(4)}, ()) == {"obs": "replicate"}


def test_a_failing_or_late_rank_fails_the_run():
    """A rank that raises, or that is still running at the time limit,
    fails the launch; the other ranks are killed."""
    with pytest.raises(distributed.RankFailure, match="rank 1 of 2 exited with code 1"):
        parallel.run_ranks(N_RANKS, _fail_on_rank_1, timeout_s=120)
    with pytest.raises(distributed.RankFailure, match=r"ranks \[0, 1\] of 2 did not finish"):
        parallel.run_ranks(N_RANKS, _sleep, 600.0, timeout_s=8)


def test_rank_seeds_differ_from_each_other_and_the_evals():
    seeds = [parallel.rank_seed(7, r) for r in range(1, 64)]
    assert parallel.rank_seed(7, 0) == 7
    assert len(set(seeds)) == len(seeds) and 7 not in seeds and 8 not in seeds
    assert all(0 <= s < 2**32 for s in seeds)

"""The port's low-dim path against the JAX package on the CPU:
``observe_lowdim``; ``make_venv``'s low-dim reset and steps (the kernel
wrappers, which run their plain versions on CPU tensors) against the JAX
venv's per-repeat composition (``soa.step_substeps_batched`` then
``observe_lowdim`` per repeat) fed the same pre-drawn randoms, actions and,
call by call, the same states; free running, a bound on the envs that part
from JAX, a float64 witness on each of them, and the port's substep
against JAX's own op-by-op one; the one-K1
step against the port's own K2-per-repeat composition, exactly; one
low-dim learner update against the JAX ``make_segment``'s ``train_once``;
and ``init_state``'s ``pixel_pool``.

Tolerances: physics as tests/test_torch_slice.py holds it (atol 1e-5;
angular velocity 1e-4 + 1e-4 relative, the pole's spin being
ill-conditioned in float32); the learner at tests/test_torch_ddpg.py's
bounds (losses rtol 2e-2, gradients 5e-2 in relative norm, params after
one Adam step within 2·lr + 1e-6, targets within τ·2·lr + 1e-6).
"""

import copy
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import ddpg as jddpg
from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.env import cartpole as jcartpole
from cartpoleplusplus_tpu.models import Actor as JActor
from cartpoleplusplus_tpu.models import Critic as JCritic
from cartpoleplusplus_tpu.physics import soa as jsoa
from cartpoleplusplus_tpu.physics.bodies import RigidState as JRigidState
from cartpoleplusplus_tpu_torch.agents import ddpg
from cartpoleplusplus_tpu_torch.agents.common import make_venv
from cartpoleplusplus_tpu_torch.env import cartpole
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.models.networks import Actor, Critic
from cartpoleplusplus_tpu_torch.physics import cuda_step
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.utils.params import (
    actor_params_from_flax,
    critic_params_from_flax,
)

torch.set_num_threads(2)

E = 64
STEPS = 3
# Low-dim (2 bodies × 7 per repeat, 3 repeats × 5 substeps, 30-substep
# push) at 64 envs; episodes capped at 2 steps so the timeout and the
# sticky-done reward are exercised.
CFG_KW = dict(discrete_actions=False, use_raw_pixels=False, max_episode_len=2)
STATE_TOL = {"pos": (1e-5, 0.0), "quat": (1e-5, 0.0), "vel": (1e-5, 0.0), "ang": (1e-4, 1e-4)}


def _random_rigid(e, seed):
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(e, 2, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return {"pos": rng.normal(size=(e, 2, 3)).astype(np.float32), "quat": quat,
            "vel": rng.normal(size=(e, 2, 3)).astype(np.float32),
            "ang": rng.normal(size=(e, 2, 3)).astype(np.float32)}


def test_observe_lowdim_matches_jax():
    arrays = _random_rigid(E, 0)
    want = jcartpole.observe_lowdim(None, JRigidState(**{k: jnp.asarray(v)
                                                         for k, v in arrays.items()}))
    got = cartpole.observe_lowdim(None, RigidState(**{k: torch.from_numpy(v)
                                                      for k, v in arrays.items()}))
    assert tuple(got.shape) == (E, 2, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # cart first, pos then quat
    np.testing.assert_array_equal(got[:, 0, :3].numpy(), arrays["pos"][:, 0])
    np.testing.assert_array_equal(got[:, 1, 3:].numpy(), arrays["quat"][:, 1])


def _torch_rigid(jrigid):
    return RigidState(**{f: torch.tensor(np.asarray(getattr(jrigid, f)))
                         for f in ("pos", "quat", "vel", "ang")})


def _state_close(got, want):
    for field, (atol, rtol) in STATE_TOL.items():
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   atol=atol, rtol=rtol, err_msg=field)


@functools.lru_cache(maxsize=None)
def _jax_fns():
    """JAX's low-dim reset, step and one repeat of substeps, jitted once."""
    jcfg = JConfig(**CFG_KW)
    jscene = jcartpole.scene_for(jcfg)
    return (jax.jit(lambda k: jcartpole.reset_batched(jcfg, jscene, k, E)),
            jax.jit(lambda st, a: jcartpole.step_batched(jcfg, jscene, st, a)),
            jax.jit(lambda r, f: jsoa.step_substeps_batched(jscene, r, f, jcfg.steps_per_repeat)))


def _rollout(seed):
    """JAX's low-dim reset + STEPS steps, through its per-repeat
    composition, and the port's venv fed the same randoms and actions:
    call by call from JAX's state (each repeat of the reset push, the
    reset frame, each step: one K1 call of 3 × 5 substeps), and free
    running on its own state."""
    jcfg, cfg = JConfig(**CFG_KW), CartpoleConfig(**CFG_KW)
    jreset, jstep, jrepeat = _jax_fns()
    key = jax.random.PRNGKey(seed)
    k_theta, k_jitter = jax.random.split(key)  # as reset_batched splits it
    theta = jax.random.uniform(k_theta, (E,), minval=0.0, maxval=2.0 * jnp.pi)
    jitter = jax.random.normal(k_jitter, (E, 2))
    actions = np.random.default_rng(1).uniform(-1.0, 1.0, (STEPS, E, 2)).astype(np.float32)
    jscene = jcartpole.scene_for(jcfg)
    venv = make_venv(cfg, E, device="cpu")
    drawn = dict(theta=torch.tensor(np.asarray(theta)), jitter=torch.tensor(np.asarray(jitter)))

    # The reset push, one repeat at a time, both sides from JAX's state.
    keep = lambda scene, rigid, force, n: rigid
    jpre, _ = jcartpole.reset_batched(jcfg, jscene, key, E, physics_fn=keep)
    pre, _ = cartpole.reset_batched(cfg, venv.scene, E, keep, cartpole.observe_lowdim, "cpu",
                                    **drawn)
    jpush = jcfg.initial_force * jnp.stack([jnp.cos(theta), jnp.sin(theta),
                                            jnp.zeros_like(theta)], axis=-1)
    push_pairs, jrigid = [(pre.rigid, jpre.rigid)], jpre.rigid
    for _ in range(cfg.initial_force_steps // cfg.steps_per_repeat):
        got = venv.physics_fn(venv.scene, _torch_rigid(jrigid), torch.tensor(np.asarray(jpush)),
                              cfg.steps_per_repeat)
        jrigid = jrepeat(jrigid, jpush)
        push_pairs.append((got, jrigid))

    jstate, jobs = jreset(key)
    frame = venv.observe_fn(venv.scene, _torch_rigid(jstate.rigid))
    jout = [(jstate.rigid, jobs, None, None)]
    out = [(push_pairs[-1][0], frame[:, None].expand((E, cfg.action_repeats, 2, 7)), None, None)]
    own = venv.reset(**drawn)
    free, state = [own[0].rigid], own[0]
    for a in actions:
        fed = EnvState(rigid=_torch_rigid(jstate.rigid),
                       steps=torch.tensor(np.asarray(jstate.steps)),
                       done=torch.tensor(np.asarray(jstate.done)))
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(a))
        jout.append((jstate.rigid, jobs, jrew, jdone))
        got, obs, rew, done = cartpole.step_batched(cfg, venv.scene, fed, torch.from_numpy(a),
                                                    venv.sim_fn)
        out.append((got.rigid, obs, rew, done))
        state = cartpole.step_batched(cfg, venv.scene, state, torch.from_numpy(a), venv.sim_fn)[0]
        free.append(state.rigid)
    return SimpleNamespace(jout=jout, out=out, push_pairs=push_pairs, own_reset=own, free=free)


SEEDS = range(12)
# Free running, a float32 trajectory parts from another at a contact
# decision taken on a different rounding (see
# test_free_running_parting_follows_float32_rounding): at most this many
# envs of E may leave the physics tolerances per seed, and of all SEEDS.
FREE_PARTED_PER_SEED = 3
FREE_PARTED_TOTAL = 10


@pytest.fixture(scope="module")
def by_seed():
    """:func:`_rollout` at every seed of SEEDS."""
    return {seed: _rollout(seed) for seed in SEEDS}


@pytest.fixture(scope="module")
def rollouts(by_seed):
    return by_seed[9]


def _beyond(got, want) -> set:
    """Envs where a state field leaves the physics tolerances."""
    envs = set()
    for field, (atol, rtol) in STATE_TOL.items():
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        envs |= set(np.nonzero((np.abs(g - w) > atol + rtol * np.abs(w)).any(axis=(1, 2)))[0])
    return envs


def _parted(r) -> list:
    """Envs whose free-running state leaves the tolerances of JAX's at any
    step of a rollout."""
    return sorted(int(e) for e in set().union(*(_beyond(g, w[0]) for g, w in zip(r.free, r.jout))))


def test_call_by_call_agreement_over_seeds(by_seed):
    """Over every seed, every call of the low-dim composition fed JAX's
    state agrees with JAX's within the physics tolerances on every env."""
    for seed, r in by_seed.items():
        called = set()
        for got, want in r.push_pairs:
            called |= _beyond(got, want)
        for (got, _, _, _), (want, _, _, _) in zip(r.out, r.jout):
            called |= _beyond(got, want)
        assert not called, f"seed {seed}: envs {sorted(called)} beyond the tolerances"


def test_free_running_parts_from_jax_on_few_envs(by_seed):
    """Fed its own state, the port's float32 trajectory leaves JAX's
    tolerances on at most FREE_PARTED_PER_SEED envs of E per seed and
    FREE_PARTED_TOTAL over all seeds (printed with ``-s``); a fault in the
    physics would part every env that touches the same contact."""
    parted = {seed: _parted(r) for seed, r in by_seed.items()}
    print("free running, envs parted from JAX by seed:", parted)
    assert max(len(v) for v in parted.values()) <= FREE_PARTED_PER_SEED, parted
    assert sum(len(v) for v in parted.values()) <= FREE_PARTED_TOTAL, parted


def _float64_free(r, seed):
    """The port's plain physics in float64 from the rollout's pre-push
    state, through the push and every step: the states of ``r.free``."""
    cfg = CartpoleConfig(**CFG_KW)
    scene = make_venv(cfg, E, device="cpu").scene
    theta = jax.random.uniform(jax.random.split(jax.random.PRNGKey(seed))[0], (E,),
                               minval=0.0, maxval=2.0 * jnp.pi)
    push = torch.tensor(np.asarray(JConfig(**CFG_KW).initial_force * jnp.stack(
        [jnp.cos(theta), jnp.sin(theta), jnp.zeros_like(theta)], axis=-1))).double()
    s = cuda_step.step_substeps(scene, r.push_pairs[0][0].map(lambda x: x.double()), push,
                                cfg.initial_force_steps)
    out = [s]
    for a in np.random.default_rng(1).uniform(-1.0, 1.0, (STEPS, E, 2)).astype(np.float32):
        force = cartpole.action_to_force(cfg, torch.from_numpy(a)).double()
        s = cuda_step.step_substeps(scene, s, force, cfg.action_repeats * cfg.steps_per_repeat)
        out.append(s)
    return out


def _gap(a, b, env) -> float:
    """Largest difference of one env's state fields."""
    return max(float(np.abs(np.asarray(getattr(a, f), np.float64)[env]
                            - np.asarray(getattr(b, f), np.float64)[env]).max())
               for f in ("pos", "quat", "vel", "ang"))


def test_free_running_parting_follows_float32_rounding(by_seed):
    """On every env that parts, a float64 run of the same physics (the
    port's plain version) is a witness: printed with ``-s``, its largest
    gap over the rollout to the port's float32 and to JAX's, and the side
    it is nearer.  A fault in the port's expression order would put
    float64 on JAX's side every time; rounding puts it on either."""
    sides = []
    for seed, r in by_seed.items():
        envs = _parted(r)
        if not envs:
            continue
        f64 = [x.map(lambda t: t.numpy()) for x in _float64_free(r, seed)]
        for env in envs:
            port = max(_gap(g, w, env) for g, w in zip(r.free, f64))
            jax_ = max(_gap(j[0], w, env) for j, w in zip(r.jout, f64))
            sides.append("port" if port < jax_ else "jax")
            print(f"seed {seed} env {env}: float64's gap to the port's float32 {port:.3g}, "
                  f"to JAX's {jax_:.3g}: nearer {sides[-1]}")
    assert "port" in sides, sides


def test_substep_follows_jax_expression_order(rollouts):
    """The push at seed 9, where the port's free-running float32 parts from
    JAX's at env 39 (at substep 16 a pole-bottom corner grazes the cart's
    top face within a few float32 ulps of zero penetration, and the two
    runs take opposite sides): JAX's own op-by-op (unjitted) run of its
    soa substep, fed the same states, gives the port's substep bit for bit
    in pos, vel and ang, and its quat to 2 ulps (the two libraries'
    rsqrt); run free, it parts from JAX's jitted run at env 39 as the port
    does and stays within the tolerances of the port.  So the port computes
    JAX's expressions in JAX's order, and the parting comes from the
    rounding of XLA's fused compilation."""
    cfg, jcfg = CartpoleConfig(**CFG_KW), JConfig(**CFG_KW)
    jscene = jcartpole.scene_for(jcfg)
    scene = make_venv(cfg, E, device="cpu").scene
    theta = jax.random.uniform(jax.random.split(jax.random.PRNGKey(9))[0], (E,),
                               minval=0.0, maxval=2.0 * jnp.pi)
    jpush = jcfg.initial_force * jnp.stack([jnp.cos(theta), jnp.sin(theta),
                                            jnp.zeros_like(theta)], axis=-1)
    push = torch.tensor(np.asarray(jpush))
    jit_one = jax.jit(lambda st, f: jsoa.step_substeps_batched(jscene, st, f, 1))
    pre = rollouts.push_pairs[0][1]
    eager, jitted, port = pre, pre, _torch_rigid(pre)
    for _ in range(cfg.initial_force_steps):
        with jax.disable_jit():
            nxt = jsoa.step_substeps_batched(jscene, eager, jpush, 1)
        got = cuda_step.step_substeps(scene, _torch_rigid(eager), push, 1)
        for f in ("pos", "vel", "ang"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(nxt, f)),
                                          err_msg=f)
        np.testing.assert_array_max_ulp(got.quat.numpy(), np.asarray(nxt.quat), maxulp=2)
        eager = nxt
        jitted = jit_one(jitted, jpush)
        port = cuda_step.step_substeps(scene, port, push, 1)
    assert _gap(eager, jitted, 39) > 1e-2
    assert _gap(port, jitted, 39) > 1e-2
    assert not _beyond(port, eager)


def test_lowdim_push_matches_jax_per_repeat(rollouts):
    """The pre-push state, then each repeat of the reset push from JAX's
    state, within the physics tolerances."""
    for got, want in rollouts.push_pairs:
        _state_close(got, want)
    # The port's own reset: its frame, repeated, of its own pushed state.
    state, obs = rollouts.own_reset
    assert torch.equal(obs, cartpole.observe_lowdim(None, state.rigid)[:, None].expand_as(obs))
    assert not state.done.any() and not state.steps.any()


@pytest.mark.parametrize("t", range(STEPS + 1))
def test_lowdim_obs_match_jax(rollouts, t):
    obs, jobs = rollouts.out[t][1], rollouts.jout[t][1]
    assert obs.dtype == torch.float32
    assert tuple(obs.shape) == (E,) + CartpoleConfig(**CFG_KW).obs_shape == (E, 3, 2, 7)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t", range(STEPS + 1))
def test_lowdim_state_matches_jax(rollouts, t):
    _state_close(rollouts.out[t][0], rollouts.jout[t][0])


@pytest.mark.parametrize("t", range(1, STEPS + 1))
def test_lowdim_reward_done_match_jax(rollouts, t):
    out, jout = rollouts.out[t], rollouts.jout[t]
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
    if t >= 2:  # the capped episodes end at step 2 and then earn 0
        assert out[3].all()
    if t == 3:
        assert (out[2] == 0).all()


def _seeded(cfg, e, seed):
    """E states after the reset push and a few random steps (plain), and a
    force for the next step."""
    venv = make_venv(cfg, e, device="cpu")
    g = torch.Generator().manual_seed(seed)
    state, _ = venv.reset(g)
    rigid = state.rigid
    for _ in range(2):
        force = cartpole.action_to_force(cfg, 2.0 * torch.rand((e, 2), generator=g) - 1.0)
        rigid = cuda_step.step_substeps(venv.scene, rigid, force, cfg.steps_per_repeat * 3)
    force = cartpole.action_to_force(cfg, 2.0 * torch.rand((e, 2), generator=g) - 1.0)
    return venv, rigid, force


@pytest.mark.parametrize("repeats,spr,seed", [(3, 5, 0), (2, 4, 1), (4, 1, 2)])
def test_one_k1_step_equals_k2_per_repeat(repeats, spr, seed):
    """The low-dim ``sim_fn`` (one K1 call, frames from its poses) equals
    the port's composition of K2 per repeat and ``observe_lowdim``, bit for
    bit (on the CPU both run the plain version)."""
    cfg = CartpoleConfig(discrete_actions=False, use_raw_pixels=False, action_repeats=repeats,
                         steps_per_repeat=spr)
    venv, rigid, force = _seeded(cfg, E, seed)
    k1_rigid, k1_obs = venv.sim_fn(venv.scene, rigid, force)
    k2_rigid, k2_obs = cartpole.simulate_repeats(cfg, venv.scene, rigid, force,
                                                 cuda_step.step_substeps, cartpole.observe_lowdim)
    assert tuple(k1_obs.shape) == (E, repeats, 2, 7)
    assert torch.equal(k1_obs, k2_obs)
    for field in ("pos", "quat", "vel", "ang"):
        assert torch.equal(getattr(k1_rigid, field), getattr(k2_rigid, field)), field
    assert torch.equal(k1_obs[:, -1], cartpole.observe_lowdim(venv.scene, k1_rigid))


# One low-dim learner update against JAX.
B = 16
HIDDEN = (32, 16)
LR_A, LR_C = 1e-4, 1e-3
TAU, GAMMA = 0.005, 0.99


@pytest.fixture(scope="module")
def update():
    """One JAX train_once (from make_segment's closure) and the same update
    in the port, on a low-dim batch from the same params."""
    jcfg, cfg = JConfig(discrete_actions=False), CartpoleConfig(discrete_actions=False)
    jactor = JActor(action_dim=2, use_raw_pixels=False, hidden=HIDDEN)
    jcritic = JCritic(use_raw_pixels=False, hidden=HIDDEN)
    k_a, k_c, k_train = jax.random.split(jax.random.PRNGKey(13), 3)
    dummy_obs = jnp.zeros((2,) + jcfg.obs_shape, jnp.float32)
    actor_vars = dict(jactor.init(k_a, dummy_obs))
    critic_vars = dict(jcritic.init(k_c, dummy_obs, jnp.zeros((2, 2), jnp.float32)))
    atx, ctx = optax.adam(LR_A), optax.adam(LR_C)
    seg = jddpg.make_segment(
        jcommon.make_venv(jcfg, 4), jactor, jcritic, atx, ctx, gamma=GAMMA, tau=TAU,
        batch_size=B, warmup_steps=0, steps_per_segment=1, ou_theta=0.15, ou_sigma=0.2)
    train_once = dict(zip(seg.__code__.co_freevars, (c.cell_contents for c in seg.__closure__)))[
        "train_once"]
    rng = np.random.default_rng(3)
    shape = (B, *cfg.obs_shape)
    batch = (rng.normal(size=shape).astype(np.float32),
             rng.uniform(-1, 1, (B, 2)).astype(np.float32),
             rng.normal(size=B).astype(np.float32),
             rng.normal(size=shape).astype(np.float32),
             rng.random(B) < 0.25)
    bundle = (actor_vars, critic_vars, actor_vars, critic_vars,
              atx.init(actor_vars["params"]), ctx.init(critic_vars["params"]))
    jbatch = tuple(jnp.asarray(x) for x in batch)
    new_bundle, losses, _ = jax.jit(train_once)(
        bundle, jbatch, jnp.ones((B,), jnp.float32), k_train, jnp.asarray(1, jnp.int32))

    # JAX's gradients at the same point.
    s1, a, r, s2, term = jbatch
    q2 = jcritic.apply(critic_vars, s2, jactor.apply(actor_vars, s2))
    y = r + GAMMA * (1.0 - term) * q2
    cgrads = jax.grad(lambda p: jnp.mean((jcritic.apply({"params": p}, s1, a) - y) ** 2))(
        critic_vars["params"])
    agrads = jax.grad(lambda p: -jnp.mean(jcritic.apply(
        new_bundle[1], s1, jactor.apply({"params": p}, s1))))(actor_vars["params"])

    kw = dict(use_raw_pixels=False, hidden=HIDDEN, device="cpu")
    actor, critic = Actor(cfg.obs_shape, **kw), Critic(cfg.obs_shape, **kw)
    actor.load_state_dict(actor_params_from_flax(jax.device_get(actor_vars)))
    critic.load_state_dict(critic_params_from_flax(jax.device_get(critic_vars)))
    actor_opt, actor_sched = ddpg.adam(actor, LR_A)
    critic_opt, critic_sched = ddpg.adam(critic, LR_C)
    st = ddpg.DDPGState(
        actor=actor, critic=critic,
        target_actor=copy.deepcopy(actor).requires_grad_(False),
        target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=actor_opt, critic_opt=critic_opt, actor_sched=actor_sched,
        critic_sched=critic_sched, replay=None, env_states=None, obs=None, ou_noise=None,
        generator=torch.Generator().manual_seed(0))
    closs, aloss = ddpg.make_train_once(cfg, gamma=GAMMA, tau=TAU, warmup_steps=0)(
        st, tuple(torch.from_numpy(x) for x in batch), 1)
    return SimpleNamespace(st=st, closs=closs, aloss=aloss, losses=losses, bundle=bundle,
                           new_bundle=new_bundle, cgrads=cgrads, agrads=agrads)


def test_lowdim_update_losses_and_gradients_match_jax(update):
    u = update
    assert float(u.closs) == pytest.approx(float(u.losses["critic_loss"]), rel=2e-2)
    assert float(u.aloss) == pytest.approx(float(u.losses["actor_loss"]), rel=2e-2)
    want = {**{"a." + k: v for k, v in actor_params_from_flax(u.agrads).items()},
            **{"c." + k: v for k, v in critic_params_from_flax(u.cgrads).items()}}
    got = {**{"a." + k: p.grad for k, p in u.st.actor.named_parameters()},
           **{"c." + k: p.grad for k, p in u.st.critic.named_parameters()}}
    assert got.keys() == want.keys()
    for k, w in want.items():
        rel = float(torch.linalg.vector_norm(got[k] - w) / torch.linalg.vector_norm(w))
        assert rel <= 5e-2, f"{k}: relative gradient error {rel:.3g}"


def test_lowdim_update_params_and_targets_match_jax(update):
    u = update
    for module, target, tree, ttree, conv, lr in (
            (u.st.actor, u.st.target_actor, u.new_bundle[0], u.new_bundle[2],
             actor_params_from_flax, LR_A),
            (u.st.critic, u.st.target_critic, u.new_bundle[1], u.new_bundle[3],
             critic_params_from_flax, LR_C)):
        want, want_t = conv(jax.device_get(tree)), conv(jax.device_get(ttree))
        for k, v in module.state_dict().items():
            assert float((v - want[k]).abs().max()) <= 2 * lr + 1e-6, k
        for k, v in target.state_dict().items():
            assert float((v - want_t[k]).abs().max()) <= TAU * 2 * lr + 1e-6, k


def test_init_state_pixel_pool_matches_flax():
    """``init_state(pixel_pool=2)`` builds pooling encoders; its actor with
    flax's params at that pool gives flax's actions (the bf16 bound of
    tests/test_torch_slice.py)."""
    kw = dict(discrete_actions=False, use_raw_pixels=True, num_cameras=1, render_width=20,
              render_height=20, obs_pool=1, obs_samples=0)
    cfg, jcfg = CartpoleConfig(**kw), JConfig(**kw)
    venv = make_venv(cfg, 4, device="cpu")
    st = ddpg.init_state(SimpleNamespace(seed=0, replay_capacity=16), cfg, venv, hidden=HIDDEN,
                         pixel_pool=2)
    assert st.actor.encoder.pixel_pool == st.critic.encoder.pixel_pool == 2
    assert st.actor.encoder.pixel_embed.in_features == cfg.obs_shape[-1] * cfg.action_repeats // 4
    jactor = JActor(action_dim=2, use_raw_pixels=True, pixel_pool=2, hidden=HIDDEN,
                    height=jcfg.obs_height, width=jcfg.obs_width)
    obs = np.random.default_rng(4).integers(0, 256, (8, *cfg.obs_shape), dtype=np.uint8)
    params = jax.tree.map(np.asarray, jactor.init(jax.random.PRNGKey(5), jnp.asarray(obs)))
    rng = np.random.default_rng(6)  # widen the ±3e-3 head, as test_torch_slice does
    params["params"]["mu"]["kernel"] = rng.normal(
        size=params["params"]["mu"]["kernel"].shape).astype(np.float32)
    want = np.asarray(jactor.apply(params, jnp.asarray(obs)))
    st.actor.load_state_dict(actor_params_from_flax(params))
    with torch.no_grad():
        got = st.actor(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert np.abs(want).max() > 0.1

"""The port's DDPG learner against the JAX package on the CPU: the Critic
and TwinCritic forward passes with params carried across by
``utils/params.py``, the random-shift augmentation, one ``train_once``
(plain DDPG and TD3: twin critics, target-policy noise, random shift,
reward scale, grad clip) against the JAX ``make_segment``'s own
``train_once`` fed the same batch and the same random draws, and the
training segment's bookkeeping (torch only).

Tolerances and why:
- losses rtol 2e-2, gradients ≤ 5e-2 in relative norm per parameter, Q
  values 2e-2 of their scale: the encoder computes in bfloat16 and the two
  frameworks round at different places (XLA may keep a product in float32
  through the bias add; the port rounds the product, then adds).
- params after one Adam step within 2·lr (+1e-6) of JAX's: Adam's first
  step moves each parameter by lr·g/(|g| + ε), so a gradient entry that
  bf16 rounding flips in sign moves it 2·lr the other way.  That bound
  holds for any gradient, so the step is also held by direction: at most
  1e-4 of a network's entries may lie more than lr from JAX's (moved the
  opposite way).  Measured on the CPU: no such entry in 1.4-2.9 M, and the
  largest gap 0.41·lr (actor) and 0.04·lr (critic).
- targets: the polyak step over the port's own params at atol 1e-6 (float32
  rounding of one multiply-add), and against JAX's targets within
  τ·2·lr + 1e-6, the online params' bound carried through τ.
"""

import copy
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
from cartpoleplusplus_tpu.models import Actor as JActor
from cartpoleplusplus_tpu.models import Critic as JCritic
from cartpoleplusplus_tpu.models import soft_target_update as jsoft_target_update
from cartpoleplusplus_tpu.replay import buffer as jbuffer
from cartpoleplusplus_tpu_torch.agents import ddpg
from cartpoleplusplus_tpu_torch.agents.common import make_venv
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.models.networks import Actor, Critic, TwinCritic
from cartpoleplusplus_tpu_torch.models.target import soft_target_update
from cartpoleplusplus_tpu_torch.utils.params import (
    actor_params_from_flax,
    critic_params_from_flax,
)

torch.set_num_threads(2)

# The 1-camera exact row's frame shape (3 repeats × 3 × 25 × 25) with a
# narrow trunk.
CFG_KW = dict(discrete_actions=False, use_raw_pixels=True, num_cameras=1, obs_pool=2,
              obs_samples=0)
HIDDEN = (32, 16)
B = 16
LR_A, LR_C = 1e-4, 1e-3
TAU, GAMMA = 0.005, 0.99
CASES = {
    "ddpg": dict(),
    "td3": dict(twin_critic=True, policy_delay=2, target_noise=0.2, target_noise_clip=0.5,
                aug_shift=2, reward_scale=0.1, grad_clip=1.0),
}


def _nets(cfg):
    kw = dict(use_raw_pixels=True, hidden=HIDDEN, height=cfg.obs_height, width=cfg.obs_width)
    return JActor(action_dim=2, **kw), JCritic(**kw)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, *cfg.obs_shape)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.uniform(-1, 1, (B, 2)).astype(np.float32),
            rng.normal(size=B).astype(np.float32),
            rng.integers(0, 256, shape, dtype=np.uint8),
            rng.random(B) < 0.25)


def _draws(k_train, hp):
    """The random draws a JAX train_once makes from ``k_train``, for the
    port: the shift offsets of s1 and s2 (None without shift) and the
    target-policy noise."""
    k_aug, k_tn = jax.random.split(k_train)
    pad = hp.get("aug_shift", 0)
    offsets = None
    if pad:
        k1, k2 = jax.random.split(k_aug)
        offsets = tuple(torch.from_numpy(np.array(jax.random.randint(k, (B, 2), 0, 2 * pad + 1)))
                        for k in (k1, k2))
    return offsets, torch.from_numpy(np.array(jax.random.normal(k_tn, (B, 2))))


@pytest.fixture(scope="module", params=list(CASES))
def update(request):
    return _one_update(request.param)


def _one_update(name):
    """One JAX train_once (from make_segment's closure) and the same update
    in the port, from the same params, batch and random draws."""
    hp = CASES[name]
    twin = hp.get("twin_critic", False)
    jcfg, cfg = JConfig(**CFG_KW), CartpoleConfig(**CFG_KW)
    jactor, jcritic = _nets(jcfg)
    key = jax.random.PRNGKey(11)
    k_a, k_c, k_train = jax.random.split(key, 3)
    dummy_obs = jnp.zeros((2,) + jcfg.obs_shape, jnp.float32)
    dummy_act = jnp.zeros((2, 2), jnp.float32)
    actor_vars = dict(jactor.init(k_a, dummy_obs))
    if twin:
        critic_vars = jax.vmap(lambda k: dict(jcritic.init(k, dummy_obs, dummy_act)))(
            jax.random.split(k_c, 2))
    else:
        critic_vars = dict(jcritic.init(k_c, dummy_obs, dummy_act))
    clip = hp.get("grad_clip", 0.0)
    tx = (lambda lr: optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))) if clip \
        else optax.adam
    atx, ctx = tx(LR_A), tx(LR_C)
    jhp = {k: v for k, v in hp.items() if k != "grad_clip"}
    seg = jddpg.make_segment(
        jcommon.make_venv(jcfg, 4), jactor, jcritic, atx, ctx, gamma=GAMMA, tau=TAU,
        batch_size=B, warmup_steps=0, steps_per_segment=1, ou_theta=0.15, ou_sigma=0.2, **jhp)
    train_once = dict(zip(seg.__code__.co_freevars, (c.cell_contents for c in seg.__closure__)))[
        "train_once"]
    batch = _batch(cfg)
    bundle = (actor_vars, critic_vars, actor_vars, critic_vars,
              atx.init(actor_vars["params"]), ctx.init(critic_vars["params"]))
    jbatch = tuple(jnp.asarray(x) for x in batch)
    new_bundle, losses, _ = jax.jit(train_once)(
        bundle, jbatch, jnp.ones((B,), jnp.float32), k_train, jnp.asarray(1, jnp.int32))

    # The draws train_once makes from k_train, handed to the port.
    offsets, target_eps = _draws(k_train, hp)

    # JAX's gradients at the same point (the update's own inputs, rebuilt
    # from the JAX building blocks), for the gradient comparison.
    s1, s2 = (jbuffer.decode_obs(x) for x in (jbatch[0], jbatch[3]))
    pad = hp.get("aug_shift", 0)
    if pad:
        k1, k2 = jax.random.split(jax.random.split(k_train)[0])
        s1 = jddpg.aug_random_shift(s1, k1, pad, jcfg.obs_height, jcfg.obs_width)
        s2 = jddpg.aug_random_shift(s2, k2, pad, jcfg.obs_height, jcfg.obs_width)
    a2 = jactor.apply(actor_vars, s2)
    if hp.get("target_noise", 0.0):
        a2 = jnp.clip(a2 + jnp.clip(hp["target_noise"] * jnp.asarray(target_eps.numpy()),
                                    -0.5, 0.5), -1.0, 1.0)
    apply_c = (lambda p, o, a: jax.vmap(lambda pp: jcritic.apply({"params": pp}, o, a))(p)) \
        if twin else (lambda p, o, a: jcritic.apply({"params": p}, o, a))
    q2 = apply_c(critic_vars["params"], s2, a2)
    q2 = jnp.min(q2, axis=0) if twin else q2
    y = hp.get("reward_scale", 1.0) * jbatch[2] + GAMMA * (1.0 - jbatch[4]) * q2
    cgrads = jax.grad(lambda p: jnp.mean((apply_c(p, s1, jbatch[1]) - y) ** 2))(
        critic_vars["params"])
    new_c = new_bundle[1]["params"]
    q1_params = jax.tree.map(lambda x: x[0], new_c) if twin else new_c
    agrads = jax.grad(lambda p: -jnp.mean(jcritic.apply(
        {"params": q1_params}, s1, jactor.apply({"params": p}, s1))))(actor_vars["params"])
    if clip:
        clip_fn = optax.clip_by_global_norm(clip)
        cgrads = clip_fn.update(cgrads, clip_fn.init(cgrads))[0]
        agrads = clip_fn.update(agrads, clip_fn.init(agrads))[0]

    # The port, from the same params.
    kw = dict(use_raw_pixels=True, hidden=HIDDEN, height=cfg.obs_height, width=cfg.obs_width,
              device="cpu")
    actor = Actor(cfg.obs_shape, **kw)
    critic = (TwinCritic if twin else Critic)(cfg.obs_shape, **kw)
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
    before = {k: v.clone() for k, v in
              {**_prefixed(st.actor, "a."), **_prefixed(st.critic, "c.")}.items()}
    port_once = ddpg.make_train_once(cfg, gamma=GAMMA, tau=TAU, warmup_steps=0, **hp)
    closs, aloss = port_once(st, tuple(torch.from_numpy(x) for x in batch), 1,
                             aug_offsets=offsets, target_eps=target_eps)
    return SimpleNamespace(name=name, hp=hp, twin=twin, cfg=cfg, st=st, closs=closs,
                           aloss=aloss, losses=losses, bundle=bundle, new_bundle=new_bundle,
                           cgrads=cgrads, agrads=agrads, before=before, port_once=port_once,
                           batch=batch, train_once=train_once)


def _prefixed(module, prefix):
    return {prefix + k: v for k, v in module.state_dict().items()}


def test_train_once_losses_match_jax(update):
    assert float(update.closs) == pytest.approx(float(update.losses["critic_loss"]), rel=2e-2)
    assert float(update.aloss) == pytest.approx(float(update.losses["actor_loss"]), rel=2e-2)
    assert float(update.closs) > 0.0


def test_train_once_gradients_match_jax(update):
    want = {**{"a." + k: v for k, v in actor_params_from_flax(update.agrads).items()},
            **{"c." + k: v for k, v in critic_params_from_flax(update.cgrads).items()}}
    got = {**{"a." + k: p.grad for k, p in update.st.actor.named_parameters()},
           **{"c." + k: p.grad for k, p in update.st.critic.named_parameters()}}
    assert got.keys() == want.keys()
    for k, w in want.items():
        rel = float(torch.linalg.vector_norm(got[k] - w) / torch.linalg.vector_norm(w))
        assert rel <= 5e-2, f"{k}: relative gradient error {rel:.3g}"


def test_train_once_params_match_jax_after_adam(update):
    new_a, new_c = update.new_bundle[0], update.new_bundle[1]
    for prefix, module, tree, conv, lr in (
            ("a.", update.st.actor, new_a, actor_params_from_flax, LR_A),
            ("c.", update.st.critic, new_c, critic_params_from_flax, LR_C)):
        want = conv(jax.device_get(tree))
        flipped = total = 0
        for k, v in module.state_dict().items():
            gap = (v - want[k]).abs()
            err = float(gap.max())
            assert err <= 2 * lr + 1e-6, f"{prefix}{k}: {err:.3g} beyond 2·lr"
            assert not torch.equal(v, update.before[prefix + k]), f"{prefix}{k} did not move"
            flipped += int((gap > lr).sum())
            total += gap.numel()
        share = flipped / total
        assert share <= 1e-4, f"{prefix}: {share:.3g} of entries moved opposite to JAX's"


def test_train_once_targets_match_jax(update):
    st = update.st
    pairs = ((st.target_actor, st.actor, update.bundle[2], update.new_bundle[2],
              actor_params_from_flax, LR_A),
             (st.target_critic, st.critic, update.bundle[3], update.new_bundle[3],
              critic_params_from_flax, LR_C))
    for target, online, old, new, conv, lr in pairs:
        # The polyak step over the port's own online params, in JAX.
        online_tree = {k: v.numpy() for k, v in online.state_dict().items()}
        old_t = conv(jax.device_get(old))
        want_step = jsoft_target_update(
            {k: jnp.asarray(v.numpy()) for k, v in old_t.items()},
            {k: jnp.asarray(v) for k, v in online_tree.items()}, TAU)
        want_jax = conv(jax.device_get(new))
        for k, v in target.state_dict().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want_step[k]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(v.numpy(), want_jax[k].numpy(), rtol=0,
                                       atol=TAU * 2 * lr + 1e-6)


def test_policy_delay_skips_actor_and_targets(update):
    """The next update (step 2) moves the critic only with policy_delay 2,
    and the actor and both targets too without it."""
    delayed = update.hp.get("policy_delay", 1) > 1
    st = update.st
    frozen = {k: v.clone() for k, v in {**_prefixed(st.actor, "a."),
                                        **_prefixed(st.target_actor, "ta."),
                                        **_prefixed(st.target_critic, "tc.")}.items()}
    critic0 = {k: v.clone() for k, v in st.critic.state_dict().items()}
    closs, aloss = update.port_once(st, tuple(torch.from_numpy(x) for x in update.batch), 2)
    after = {**_prefixed(st.actor, "a."), **_prefixed(st.target_actor, "ta."),
             **_prefixed(st.target_critic, "tc.")}
    assert float(closs) > 0.0
    assert (float(aloss) == 0.0) == delayed
    moved = [k for k, v in frozen.items() if not torch.equal(after[k], v)]
    assert (moved == []) if delayed else (len(moved) == len(frozen))
    assert not all(torch.equal(v, critic0[k]) for k, v in st.critic.state_dict().items())


@pytest.fixture(scope="module", params=list(CASES))
def two_updates(request):
    """A second update after :func:`_one_update`'s first, in JAX and in the
    port, on a second batch with fresh draws (step 2)."""
    u = _one_update(request.param)
    batch = _batch(u.cfg, seed=1)
    key = jax.random.PRNGKey(12)
    bundle, losses, _ = jax.jit(u.train_once)(
        u.new_bundle, tuple(jnp.asarray(x) for x in batch), jnp.ones((B,), jnp.float32), key,
        jnp.asarray(2, jnp.int32))
    offsets, target_eps = _draws(key, u.hp)
    closs, aloss = u.port_once(u.st, tuple(torch.from_numpy(x) for x in batch), 2,
                               aug_offsets=offsets, target_eps=target_eps)
    return SimpleNamespace(u=u, bundle=bundle, losses=losses, closs=closs, aloss=aloss)


# After two Adam steps no per-step saturation bounds the gap (the second
# step's size depends on both gradients), so the bound is the measured one
# with room: the largest gap on the CPU was 0.43·lr (actor, DDPG) and
# 0.07·lr (critic, TD3); the bound is 1·lr.
TWO_STEP_GAP_LR = 1.0


def test_train_once_params_match_jax_after_two_updates(two_updates):
    t, u = two_updates, two_updates.u
    assert float(t.closs) == pytest.approx(float(t.losses["critic_loss"]), rel=2e-2)
    gaps = {}
    for prefix, module, tree, conv, lr in (
            ("a.", u.st.actor, t.bundle[0], actor_params_from_flax, LR_A),
            ("c.", u.st.critic, t.bundle[1], critic_params_from_flax, LR_C)):
        want = conv(jax.device_get(tree))
        gaps[prefix] = max(float((v - want[k]).abs().max()) / lr
                           for k, v in module.state_dict().items())
    print(f"{u.name}: largest gap after two updates, in lr: actor {gaps['a.']:.3f}, "
          f"critic {gaps['c.']:.3f}")
    assert all(g <= TWO_STEP_GAP_LR for g in gaps.values()), gaps


@pytest.mark.parametrize("twin", [False, True])
def test_critic_forward_matches_jax(twin):
    jcfg, cfg = JConfig(**CFG_KW), CartpoleConfig(**CFG_KW)
    _, jcritic = _nets(jcfg)
    obs, act, _, _, _ = _batch(cfg, seed=3)
    dummy = (jnp.zeros((2,) + jcfg.obs_shape), jnp.zeros((2, 2)))
    key = jax.random.PRNGKey(4)
    if twin:
        params = jax.vmap(lambda k: dict(jcritic.init(k, *dummy)))(jax.random.split(key, 2))
        want = jax.vmap(lambda p: jcritic.apply(p, jnp.asarray(obs), jnp.asarray(act)))(params)
    else:
        params = dict(jcritic.init(key, *dummy))
        want = jcritic.apply(params, jnp.asarray(obs), jnp.asarray(act))
    critic = (TwinCritic if twin else Critic)(cfg.obs_shape, use_raw_pixels=True, hidden=HIDDEN,
                                              height=cfg.obs_height, width=cfg.obs_width,
                                              device="cpu")
    critic.load_state_dict(critic_params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = critic(torch.from_numpy(obs), torch.from_numpy(act))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == ((2, B) if twin else (B,))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2 * np.abs(want).max())
    if twin:
        with torch.no_grad():
            q1 = critic.q1(torch.from_numpy(obs), torch.from_numpy(act))
        assert torch.equal(q1, got[0])


def test_aug_random_shift_matches_jax():
    """Same offsets; JAX's one-hot bf16 matmuls round the values to bf16,
    which the encoder's first cast does on the port's side."""
    cfg = CartpoleConfig(**CFG_KW)
    x = np.random.default_rng(5).uniform(0, 1, (B, *cfg.obs_shape)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jddpg.aug_random_shift(jnp.asarray(x), key, 2, cfg.obs_height, cfg.obs_width)
    off = torch.from_numpy(np.array(jax.random.randint(key, (B, 2), 0, 5)))
    got = ddpg.aug_random_shift(torch.from_numpy(x), 2, cfg.obs_height, cfg.obs_width,
                                offsets=off)
    assert got.shape == (B, *cfg.obs_shape)
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(),
                                  np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))
    drawn = ddpg.aug_random_shift(torch.from_numpy(x), 2, cfg.obs_height, cfg.obs_width,
                                  generator=torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape


def test_soft_target_update_matches_jax():
    rng = np.random.default_rng(7)
    t = {"w": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=3).astype(np.float32)}
    o = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in t.items()}
    target, online = torch.nn.Module(), torch.nn.Module()
    for m, d in ((target, t), (online, o)):
        for k, v in d.items():
            m.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    soft_target_update(target, online, 0.1)
    want = jsoft_target_update({k: jnp.asarray(v) for k, v in t.items()},
                               {k: jnp.asarray(v) for k, v in o.items()}, 0.1)
    for k in t:
        np.testing.assert_allclose(getattr(target, k).detach().numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def segment_run():
    """Segments of the plain versions on 16 envs: warmup 2, replay of 4
    blocks (min fill 48 transitions), episodes capped at 3 steps."""
    cfg = CartpoleConfig(max_episode_len=3, **CFG_KW)
    venv = make_venv(cfg, 16, device="cpu")
    st = ddpg.init_state(SimpleNamespace(seed=0, replay_capacity=64), cfg, venv, hidden=HIDDEN)
    hp = dict(gamma=GAMMA, tau=TAU, batch_size=8, warmup_steps=2, ou_theta=0.15, ou_sigma=0.2)
    actor0 = {k: v.clone() for k, v in st.actor.state_dict().items()}
    first = ddpg.make_segment(venv, steps_per_segment=2, **hp)(st)
    after_first = dict(size=st.replay.size, cursor=st.replay.cursor, steps=st.env_steps,
                       actor_same=all(torch.equal(v, actor0[k])
                                      for k, v in st.actor.state_dict().items()))
    second = ddpg.make_segment(venv, steps_per_segment=1, **hp)(st)
    after_second = dict(size=st.replay.size, cursor=st.replay.cursor, steps=st.env_steps,
                        ou=st.ou_noise.clone(), done=st.env_states.done.clone())
    third = ddpg.make_segment(venv, steps_per_segment=3, **hp)(st)
    return SimpleNamespace(st=st, first=first, second=second, third=third,
                           after_first=after_first, after_second=after_second)


def test_segment_gate_opens_at_warmup_plus_one(segment_run):
    r = segment_run
    assert r.first["updates"] == 0 and r.after_first["actor_same"]
    assert float(r.first["critic_loss"]) == 0.0 and float(r.first["actor_loss"]) == 0.0
    assert (r.after_first["size"], r.after_first["cursor"], r.after_first["steps"]) == (32, 32, 2)
    # Step 3 = warmup + 1 with 48 transitions: the first update.
    assert r.second["updates"] == 1 and float(r.second["critic_loss"]) > 0.0
    assert (r.after_second["size"], r.after_second["cursor"], r.after_second["steps"]) == (48, 48, 3)
    assert r.third["updates"] == 3
    assert (r.st.replay.size, r.st.replay.cursor, r.st.env_steps) == (64, 32, 6)


def test_segment_resets_ou_noise_where_done(segment_run):
    """Step 3 ends every episode (the length cap): OU noise is zero there,
    and the state carried on is the reset pool's."""
    r = segment_run
    assert bool(r.after_second["done"].logical_not().all())  # carried states are fresh
    assert torch.equal(r.after_second["ou"], torch.zeros_like(r.after_second["ou"]))
    assert float(r.second["done_frac"]) == 1.0
    for m in (r.first, r.second, r.third):
        frac = float(m["double_reset_frac"])
        assert 0.0 <= frac <= 1.0
        assert all(np.isfinite(float(m[k])) for k in ("critic_loss", "actor_loss", "reward"))
    assert r.st.obs.shape == (16, *r.st.replay.s1.shape[1:])


def test_adam_follows_a_cosine_schedule():
    """A schedule from make_lr sets the learning rate of every update, as
    optax reads its schedule at the update count."""
    from cartpoleplusplus_tpu_torch.agents.common import make_lr

    opts = SimpleNamespace(lr_schedule="cosine", num_train_batches=2, steps_per_segment=3)
    schedule = make_lr(opts, 1e-3)
    layer = torch.nn.Linear(3, 2)
    opt, sched = ddpg.adam(layer, schedule)
    jopt = optax.adam(optax.cosine_decay_schedule(1e-3, 6, alpha=0.02))
    params = {"w": jnp.asarray(layer.weight.detach().numpy().copy())}
    state = jopt.init(params)
    for count in range(8):
        assert opt.param_groups[0]["lr"] == pytest.approx(schedule(count), rel=1e-12)
        g = np.full((2, 3), 0.5 - count, np.float32)
        layer.weight.grad, layer.bias.grad = torch.from_numpy(g.copy()), torch.zeros(2)
        opt.step()
        sched.step()
        upd, state = jopt.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
        np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(params["w"]),
                                   rtol=0, atol=1e-6)
    assert ddpg.adam(layer, 1e-3)[1] is None

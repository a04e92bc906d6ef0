"""The port's PPO against the JAX package on the CPU: the ``ValueNetwork``
(dense low-dim, dense and conv pixels) with params carried across by
``utils/params.py``; ``tanh_gaussian_logp`` (pre-squash |u| up to 15);
GAE(λ), returns and whitened advantages against JAX's reverse scan on a
batch with dones; one whole update against the JAX ``make_train_step``'s
``train_step`` at 2 epochs × 2 minibatches, fed JAX's draws (the reset
pool's push directions and tilts, the rollout's normals, each epoch's
permutation); the minibatch guard; the cosine schedule and the joint
gradient clip against optax.

Tolerances, as ROADMAP's parity rules set them:
- the log-prob 1e-4 (sums of a few float32 terms of up to ~60 at |u| =
  15), GAE and whitening 1e-6 of their scale (the same float32
  expressions in the same order; XLA may contract a multiply-add);
- network outputs 2e-2 of their scale (the bf16 bound); physics as
  tests/test_torch_slice.py holds it (atol 1e-5; angular velocity 1e-4 +
  1e-4 relative);
- losses rtol 2e-2, gradients ≤ 5e-2 in relative norm per parameter;
- the params after the update's four Adam steps within
  ``PARAM_LR_BOUND``·lr of JAX's (argued and measured at its definition).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import ppo as jppo
from cartpoleplusplus_tpu.env.config import config_from_opts as jconfig_from_opts
from cartpoleplusplus_tpu.env.vector import resolve_obs as jresolve_obs
from cartpoleplusplus_tpu.models import GaussianActor as JGaussianActor
from cartpoleplusplus_tpu.models import ValueNetwork as JValueNetwork
from cartpoleplusplus_tpu_torch.agents import common, ppo
from cartpoleplusplus_tpu_torch.agents.ddpg import _step, adam
from cartpoleplusplus_tpu_torch.env.cartpole import EnvState
from cartpoleplusplus_tpu_torch.env.config import config_from_opts
from cartpoleplusplus_tpu_torch.models.networks import GaussianActor, ValueNetwork
from cartpoleplusplus_tpu_torch.physics.bodies import RigidState
from cartpoleplusplus_tpu_torch.utils.params import (
    gaussian_actor_params_from_flax,
    value_params_from_flax,
)

torch.set_num_threads(2)

ATOL = 2e-2
HIDDEN = (16, 16)
STATE_TOL = {"pos": (1e-5, 0.0), "quat": (1e-5, 0.0), "vel": (1e-5, 0.0), "ang": (1e-4, 1e-4)}
LR = 1e-3
# Low-dim, 8 envs, 8 rollout steps, episodes capped at 5 steps (so the
# rollout crosses time-limit dones and the reset pool), 2 epochs × 2
# minibatches of 32, rewards scaled by 0.1, the default clip 0.5.
ARGV = ["--num-envs", "8", "--rollout-steps", "8", "--ppo-epochs", "2", "--ppo-minibatches",
        "2", "--max-episode-len", "5", "--hidden", *map(str, HIDDEN), "--learning-rate", str(LR),
        "--reward-scale", "0.1", "--seed", "3"]
# The params after the update's 4 Adam steps.  Adam moves a parameter by at
# most ~lr a step, so 4·lr is the vacuous bound.  Each step here starts
# from gradients within 5e-2 (relative norm) of JAX's, so its normalised
# step m̂/√v̂ is within ~5e-2 of JAX's where the moments follow the
# gradients: at most ~0.05·lr a step, 0.2·lr over four.  Measured on the
# CPU: 0.016·lr (actor) and 0.006·lr (value).  It fails if an entry's
# update flips sign or the two sides step on different minibatches.
PARAM_LR_BOUND = 0.2


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomize(params, seed):
    """Every leaf from a seeded normal of std 1/√fan_in (biases 0.1), the
    head ``v`` of std 1: its final-layer init would leave it near 0."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        x = np.asarray(x)
        if path[-1].key == "bias":
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        std = 1.0 if path[-2].key == "v" else 1.0 / np.sqrt(np.prod(x.shape[:-1]))
        return (std * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("encoder,side,cams", [("lowdim", 0, 0), ("dense", 25, 1),
                                               ("conv", 25, 2)])
def test_value_network_matches_flax(encoder, side, cams):
    rng = np.random.default_rng(1)
    if encoder == "lowdim":
        obs = rng.normal(size=(6, 3, 2, 7)).astype(np.float32)
        kw = dict(use_raw_pixels=False, hidden=HIDDEN)
    else:
        obs = rng.integers(0, 256, (6, 2, cams * 3 * side * side), dtype=np.uint8)
        kw = dict(use_raw_pixels=True, hidden=HIDDEN, pixel_encoder=encoder, height=side,
                  width=side)
    jvalue = JValueNetwork(**kw)
    params = _randomize(jvalue.init(jax.random.PRNGKey(2), jnp.zeros(obs.shape)), side + cams)
    want = np.asarray(jvalue.apply(params, jnp.asarray(obs)))
    value = ValueNetwork(obs.shape[1:], device="cpu", **kw)
    value.load_state_dict(value_params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = value(_t(obs))
    assert got.shape == (6,) and want.shape == (6,)
    assert np.abs(want).max() > 0.05 and want.max() - want.min() > 0.02
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL * np.abs(want).max())


def test_value_network_init_like_flax():
    """The head ``v`` takes the final-layer init (±3e-3 uniform) and the
    hidden layers LeCun normal with zero bias, as flax initialises them."""
    value = ValueNetwork((3, 2, 7), hidden=(64, 32), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    value.requires_grad_(False)
    assert float(value.v.weight.abs().max()) <= 3e-3 and float(value.v.bias.abs().max()) <= 3e-3
    w = value.encoder.trunk.hidden[0].weight
    assert abs(float(w.std()) * np.sqrt(42) - 1.0) < 0.1
    assert float(value.encoder.trunk.hidden[0].bias.abs().max()) == 0.0


def test_tanh_gaussian_logp_matches_jax():
    """The same (mu, log_std, u), pre-squash |u| up to 15 (tanh saturated,
    where log(1 − tanh²) needs the stable identity)."""
    rng = np.random.default_rng(0)
    n = 4096
    mu = rng.uniform(-15.0, 15.0, (n, 2)).astype(np.float32)
    log_std = rng.uniform(-5.0, 2.0, (n, 2)).astype(np.float32)
    u = (mu + np.exp(log_std) * rng.normal(size=(n, 2))).astype(np.float32)
    u[:6] = [[15.0, -15.0], [14.9, -14.9], [10.0, -10.0], [0.0, 0.0], [1e-3, -1e-3], [5.0, -5.0]]
    u = np.clip(u, -15.0, 15.0)
    want = np.asarray(jppo.tanh_gaussian_logp(jnp.asarray(mu), jnp.asarray(log_std),
                                              jnp.asarray(u)))
    got = ppo.tanh_gaussian_logp(_t(mu), _t(log_std), _t(u))
    assert float(np.abs(u).max()) == 15.0
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def _jax_gae(rew, v, done, v_last, gamma, lam):
    """The JAX train_step's GAE and whitening (agents/ppo.py:158-186)."""
    not_done = 1.0 - done.astype(jnp.float32)

    def gae_body(adv_next, x):
        r, v, nd, v_next = x
        delta = r + gamma * v_next * nd - v
        adv = delta + gamma * lam * nd * adv_next
        return adv, adv

    v_next_t = jnp.concatenate([v[1:], v_last[None]], axis=0)
    _, adv = jax.lax.scan(gae_body, jnp.zeros_like(v_last), (rew, v, not_done, v_next_t),
                          reverse=True)
    flat = adv.reshape(-1)
    return adv, adv + v, (flat - flat.mean()) * jax.lax.rsqrt(flat.var() + 1e-8)


def test_gae_matches_jax():
    rng = np.random.default_rng(5)
    t, e = 16, 12
    rew = rng.uniform(0.0, 0.1, (t, e)).astype(np.float32)
    v = rng.normal(size=(t, e)).astype(np.float32)
    done = rng.random((t, e)) < 0.15
    v_last = rng.normal(size=e).astype(np.float32)
    assert done.any() and not done.all()
    adv_j, ret_j, white_j = (np.asarray(x) for x in _jax_gae(
        jnp.asarray(rew), jnp.asarray(v), jnp.asarray(done), jnp.asarray(v_last), 0.99, 0.95))
    adv, ret = ppo.gae(_t(rew), _t(v), _t(done), _t(v_last), 0.99, 0.95)
    white = ppo.whiten(adv.reshape(-1))
    for got, want in ((adv, adv_j), (ret, ret_j), (white, white_j)):
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    # A done cuts the bootstrap: the last step of an env done there is r − v.
    d = np.nonzero(done[-1])[0]
    np.testing.assert_allclose(adv[-1, d].numpy(), rew[-1, d] - v[-1, d], rtol=0, atol=1e-6)
    # Whitening uses the population variance (ddof 0).
    assert abs(float(white.var(correction=0)) - 1.0) < 1e-5


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _jax_opts(extra=()):
    parser = jcommon.make_parser("t")
    jppo.add_ppo_opts(parser)
    return parser.parse_args(ARGV + list(extra))


def _torch_env(jstates):
    r = jstates.rigid
    return EnvState(rigid=RigidState(**{f: _t(getattr(r, f)) for f in ("pos", "quat", "vel",
                                                                         "ang")}),
                    steps=_t(jstates.steps), done=_t(jstates.done))


@pytest.fixture(scope="module")
def update():
    """One JAX PPO train_step and the port's, from the same params, env
    states and draws; JAX's rollout replayed from its own pieces (the
    train_step's scan body) for the per-step tensors."""
    opts = _jax_opts()
    jcfg = jconfig_from_opts(opts, discrete_actions=False)
    jvenv = jcommon.make_venv(jcfg, opts.num_envs)
    kw = dict(use_raw_pixels=False, hidden=HIDDEN)
    jactor, jvalue = JGaussianActor(action_dim=2, **kw), JValueNetwork(**kw)
    k_a, k_v, k_env, rng = jax.random.split(jax.random.PRNGKey(11), 4)
    dummy = jnp.zeros((1,) + jcfg.obs_shape)
    params = {"actor": jactor.init(k_a, dummy), "value": jvalue.init(k_v, dummy)}
    tx = optax.chain(optax.clip_by_global_norm(opts.grad_clip), optax.adam(LR))
    env_states, obs = jvenv.reset(k_env)
    ps = jppo.PPOState(params=params, opt_state=tx.init(params), env_states=env_states, obs=obs,
                       rng=rng, update=jnp.zeros((), jnp.int32))
    train_step = jppo.make_train_step(jvenv, jactor, jvalue, tx, opts)
    new_ps, metrics = jax.jit(train_step)(ps)

    # JAX's draws, split as its train_step splits them.
    T, E, M, K = opts.rollout_steps, opts.num_envs, opts.ppo_minibatches, opts.ppo_epochs
    _, k_reset, k_roll, k_perm = jax.random.split(rng, 4)
    k_theta, k_jitter = jax.random.split(k_reset)
    theta = jax.random.uniform(k_theta, (E,), minval=0.0, maxval=2.0 * jnp.pi)
    jitter = jax.random.normal(k_jitter, (E, 2))
    keys = jax.random.split(k_roll, T)
    eps = jnp.stack([jax.random.normal(k, (E, 2)) for k in keys])
    perms = jnp.stack([jax.random.permutation(k, T * E) for k in jax.random.split(k_perm, K)])

    # JAX's rollout from its pieces, as train_step's rollout_body runs it.
    reset_pool = jvenv.reset(k_reset)

    def body(carry, k):
        states, o = carry
        mu, log_std = jactor.apply(params["actor"], o)
        u = mu + jnp.exp(log_std) * jax.random.normal(k, mu.shape)
        logp = jppo.tanh_gaussian_logp(mu, log_std, u)
        v = jvalue.apply(params["value"], o)
        nstates, nobs_raw, reward, done = jvenv.step_lazy(states, jnp.tanh(u), reset_pool)
        return (nstates, jresolve_obs(done, reset_pool[1], nobs_raw)), (o, u, logp, v, reward,
                                                                         done)

    (_, obs_last), jroll = jax.jit(lambda: jax.lax.scan(body, (env_states, obs), keys))()
    jroll = dict(zip(("obs", "u", "logp", "v", "reward", "done"), jroll))
    jroll["v_last"] = jvalue.apply(params["value"], obs_last)
    adv_j, ret_j, white_j = _jax_gae(jroll["reward"] * opts.reward_scale, jroll["v"],
                                     jroll["done"], jroll["v_last"], opts.gamma, opts.gae_lambda)
    flat = lambda x: x.reshape((T * E,) + x.shape[2:])
    idx = perms[0][:(T * E) // M]
    jbatch = tuple(flat(x)[idx] for x in (jroll["obs"], jroll["u"], jroll["logp"]))
    jbatch += (white_j[idx], flat(ret_j)[idx])
    loss_fn = _closure(train_step)["loss_fn"]
    (jloss, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params, *jbatch)

    # The port from the same params and env states.
    cfg = config_from_opts(ppo.make_parser().parse_args(ARGV), discrete_actions=False)
    venv = common.make_venv(cfg, E, device="cpu")

    def port_state():
        actor = GaussianActor(cfg.obs_shape, device="cpu", **kw)
        value = ValueNetwork(cfg.obs_shape, device="cpu", **kw)
        actor.load_state_dict(gaussian_actor_params_from_flax(jax.device_get(params["actor"])))
        value.load_state_dict(value_params_from_flax(jax.device_get(params["value"])))
        opt, sched = adam(torch.nn.ModuleList([actor, value]), LR)
        return ppo.PPOState(actor=actor, value=value, opt=opt, sched=sched,
                            env_states=_torch_env(env_states), obs=_t(obs),
                            generator=torch.Generator().manual_seed(0))

    draws = dict(eps=_t(eps), perms=_t(perms).long(), reset=(_t(theta), _t(jitter)))
    st = port_state()
    roll = ppo.rollout(venv, st, T, venv.reset(None, *draws["reset"]), draws["eps"])
    adv, ret = ppo.gae(roll["reward"] * opts.reward_scale, roll["v"], roll["done"],
                       roll["v_last"], opts.gamma, opts.gae_lambda)
    white = ppo.whiten(adv.reshape(-1))
    st = port_state()
    pidx = draws["perms"][0][:(T * E) // M]
    batch = tuple(x.reshape((T * E,) + x.shape[2:])[pidx] for x in (roll["obs"], roll["u"],
                                                                       roll["logp"]))
    batch += (white[pidx], ret.reshape(-1)[pidx])
    loss_kw = dict(clip=opts.ppo_clip, value_coef=opts.value_coef,
                   entropy_coef=opts.entropy_coef)
    loss, aux = ppo.ppo_loss(st.actor, st.value, *batch, **loss_kw)
    loss.backward()
    grads = {"actor": {n: p.grad.clone() for n, p in st.actor.named_parameters()},
             "value": {n: p.grad.clone() for n, p in st.value.named_parameters()}}

    st = port_state()
    got = ppo.make_train_step(venv, ppo.make_parser().parse_args(ARGV))(st, **draws)
    return SimpleNamespace(opts=opts, jroll=jroll, roll=roll, adv_j=adv_j, adv=adv,
                           white_j=white_j, white=white, jloss=(jloss, *jaux),
                           loss=(loss, *aux), jgrads=jgrads, grads=grads, new_ps=new_ps,
                           metrics=metrics, st=st, got=got)


def test_update_rollout_matches_jax(update):
    """The rollout tensors: obs (physics), u and log π of the bf16 policy
    (2e-2), V (2e-2 of its scale), rewards and dones equal; the replayed
    JAX rollout is the train_step's own (its reward and done shares)."""
    u, j = update.roll, update.jroll
    assert bool(j["done"].any()) and not bool(j["done"].all())
    np.testing.assert_array_equal(u["done"].numpy(), np.asarray(j["done"]))
    np.testing.assert_array_equal(u["reward"].numpy(), np.asarray(j["reward"]))
    assert float(update.metrics["done_frac"]) == float(np.asarray(j["done"]).mean())
    np.testing.assert_allclose(u["obs"].numpy(), np.asarray(j["obs"]), rtol=0, atol=1e-5)
    for k in ("u", "logp", "v", "v_last"):
        want = np.asarray(j[k])
        np.testing.assert_allclose(u[k].numpy(), want, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(want).max()), err_msg=k)


def test_update_advantages_match_jax(update):
    """GAE over the two rollouts (V within the bf16 bound) and the whitened
    advantages, within 2e-2 of their scale."""
    for got, want in ((update.adv, update.adv_j), (update.white, update.white_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(want).max()))


def test_update_first_minibatch_loss_and_grads_match_jax(update):
    """The first minibatch of the first epoch, at the update's starting
    params: loss, pg, value and entropy terms within rtol 2e-2, the
    clipped share 0 and the KL within 1e-6 of 0 (the ratio is 1 up to the
    rounding of a forward over another batch size), the gradients of both
    networks within 5e-2 in relative norm."""
    names = ("loss", "pg_loss", "v_loss", "entropy", "clip_frac", "approx_kl")
    for name, got, want in zip(names, update.loss, update.jloss):
        got, want = float(got.detach()), float(want)
        if name in ("clip_frac", "approx_kl"):
            assert abs(got) <= 1e-6 and abs(want) <= 1e-6, name
        else:
            np.testing.assert_allclose(got, want, rtol=2e-2, err_msg=name)
    for net, to_flax in (("actor", gaussian_actor_params_from_flax),
                         ("value", value_params_from_flax)):
        want = to_flax(jax.device_get(update.jgrads[net]))
        for n, g in update.grads[net].items():
            w = want[n]
            rel = float(torch.linalg.norm(g - w) / max(float(torch.linalg.norm(w)), 1e-12))
            assert rel <= 5e-2, (net, n, rel)


def _lr_gaps(update):
    gaps = {}
    for net, module, to_flax in (("actor", update.st.actor, gaussian_actor_params_from_flax),
                                 ("value", update.st.value, value_params_from_flax)):
        want = to_flax(jax.device_get(update.new_ps.params[net]))
        gaps[net] = torch.cat([((p.detach() - want[n]).abs() / LR).reshape(-1)
                               for n, p in module.named_parameters()])
    return gaps


def test_update_params_match_jax(update):
    """After the update's 4 Adam steps every parameter lies within
    PARAM_LR_BOUND·lr of JAX's (``-s`` prints the largest gap per network
    in units of lr); ``update`` advanced."""
    gaps = _lr_gaps(update)
    print("largest gap in lr:", {k: float(v.max()) for k, v in gaps.items()})
    for net, gap in gaps.items():
        assert float(gap.max()) <= PARAM_LR_BOUND, (net, float(gap.max()))
    assert update.st.update == 1 and int(update.new_ps.update) == 1


def test_update_metrics_and_env_match_jax(update):
    """The update's metrics (the last minibatch's loss terms within rtol
    2e-2, clip share and KL within 2e-2 absolute, reward and done shares
    equal) and the env states and obs it leaves (physics tolerances)."""
    for k in ppo.METRIC_KEYS:
        got, want = float(update.got[k]), float(update.metrics[k])
        if k in ("clip_frac", "approx_kl"):
            assert abs(got - want) <= 2e-2, k
        elif k in ("mean_reward", "done_frac"):
            assert got == pytest.approx(want, rel=1e-6), k
        else:
            assert got == pytest.approx(want, rel=2e-2), k
    j = update.new_ps.env_states
    for field, (atol, rtol) in STATE_TOL.items():
        np.testing.assert_allclose(getattr(update.st.env_states.rigid, field).numpy(),
                                   np.asarray(getattr(j.rigid, field)), atol=atol, rtol=rtol)
    np.testing.assert_array_equal(update.st.env_states.steps.numpy(), np.asarray(j.steps))
    np.testing.assert_allclose(update.st.obs.numpy(), np.asarray(update.new_ps.obs), atol=1e-5)


def test_minibatch_divisibility_guard():
    cfg = config_from_opts(ppo.make_parser().parse_args(ARGV), discrete_actions=False)
    venv = common.make_venv(cfg, 8, device="cpu")
    with pytest.raises(SystemExit, match="must divide"):
        ppo.make_train_step(venv, ppo.make_parser().parse_args(ARGV + ["--ppo-minibatches", "7"]))
    ppo.make_train_step(venv, ppo.make_parser().parse_args(ARGV + ["--ppo-minibatches", "16"]))


@pytest.mark.parametrize("total", [1, 7, 2400])
def test_cosine_schedule_matches_optax(total):
    opts = SimpleNamespace(lr_schedule="cosine")
    sched = common.make_lr(opts, 3e-4, total)
    want = optax.cosine_decay_schedule(3e-4, total, alpha=0.02)
    for count in sorted({0, 1, total // 3, total // 2, max(total - 1, 0), total, total + 5}):
        assert sched(count) == pytest.approx(float(want(count)), rel=1e-6), count
    assert common.make_lr(SimpleNamespace(lr_schedule="const"), 3e-4, total) == 3e-4


def test_joint_clip_matches_optax():
    """The update's clip is one global norm over the actor and the value
    network together (``optax.chain(clip_by_global_norm, adam)`` over the
    joint params), not one per network: the gradients after ``_step``
    equal optax's clipped tree, and differ from clipping each network
    alone."""
    kw = dict(use_raw_pixels=False, hidden=HIDDEN, device="cpu")
    actor, value = GaussianActor((3, 2, 7), **kw), ValueNetwork((3, 2, 7), **kw)
    opt, _ = adam(torch.nn.ModuleList([actor, value]), LR)
    rng = np.random.default_rng(2)
    grads = {}
    for net, module, scale in (("actor", actor, 1.0), ("value", value, 10.0)):
        for n, p in module.named_parameters():
            p.grad = torch.from_numpy((scale * rng.normal(size=p.shape)).astype(np.float32))
            grads[f"{net}.{n}"] = p.grad.numpy().copy()
    clip = optax.clip_by_global_norm(0.5)
    want = clip.update({k: jnp.asarray(v) for k, v in grads.items()}, clip.init(None))[0]
    params = [*actor.parameters(), *value.parameters()]
    _step(opt, None, params, 0.5)
    named = {f"actor.{n}": p for n, p in actor.named_parameters()}
    named.update({f"value.{n}": p for n, p in value.named_parameters()})
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-9)
    alone = np.sqrt(sum((g ** 2).sum() for k, g in grads.items() if k.startswith("actor")))
    joint = np.sqrt(sum((g ** 2).sum() for g in grads.values()))
    assert 0.5 / joint < 0.5 / alone < 1.0

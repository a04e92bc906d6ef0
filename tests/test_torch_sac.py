"""The port's SAC against the JAX package on the CPU: ``sample_action``
(saturated pre-squash values included), the ``GaussianActor`` (dense and
conv encoders) with params carried across by ``utils/params.py``, one and
two ``train_once`` updates against the JAX ``make_segment``'s own
``train_once`` fed the same batch and the same random draws (the plain
recipe, DrQ shift + reward scale + grad clip, and the pixel learning run's
recipe at its exact network and loss), the temperature floor,
and the config-5 SAC checkpoint read without flax (greedy actions against
flax on its carried observations; the chip's npz of its actor equal to it
leaf for leaf).

Tolerances, as ``tests/test_torch_ddpg.py`` sets them and why:
- ``sample_action``: actions 1e-6 (one tanh of the same float32 input),
  log π 1e-4 (sums of a few float32 terms of up to ~60 at |u| = 15);
- the actor's (mu, log_std) and Q: 2e-2 of their scale, the bf16 bound;
- losses rtol 2e-2, gradients ≤ 5e-2 in relative norm per parameter;
- params after one Adam step within 2·lr (+1e-6): Adam's first step moves
  each parameter by lr·g/(|g| + ε), so a bf16-flipped gradient sign moves
  it 2·lr the other way; at most 1e-4 of a network's entries more than lr
  away.  ``log_alpha`` is a float32 scalar with the same bound in its
  own lr.  After two updates, 1·lr (test_torch_ddpg.py's measured bound).
- the target critic: the polyak step over the port's own critic at 1e-6.

The recipe case (``scripts/torch_sac_pixels.py``'s network and loss) meets
these bounds but two: its conv trunks' bias gradients are left out of the
gradient bound, because JAX on the CPU sums a bfloat16 bias add's gradient
in bfloat16 (``test_jax_cpu_sums_a_bf16_bias_add_gradient_in_bf16``: 9.6 %
off the exact sum at the first conv's shape, the port's 0.16 %), and port
and reference differ there by up to 11.7 %
(``scripts/sac_recipe_update_probe.py``); and it has no two-update case: a
bias entry whose reference gradient flipped sign moves 2·lr apart in the
first step, and the second step spreads that over the encoders (up to
2.04·lr on the actor and 1.61·lr on the critic, against the 1·lr bound).
"""

import copy
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import sac as jsac
from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.models import Critic as JCritic
from cartpoleplusplus_tpu.models import GaussianActor as JGaussianActor
from cartpoleplusplus_tpu_torch.agents import ddpg, sac
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.models.networks import GaussianActor, TwinCritic
from cartpoleplusplus_tpu_torch.utils import flax_msgpack
from cartpoleplusplus_tpu_torch.utils.params import (
    critic_params_from_flax,
    flatten_tree,
    gaussian_actor_params_from_flax,
    sac_params_from_jax_checkpoint,
    unflatten_tree,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "runs", "ckpt_sac_cfg5_s0", "ckpt_15000.msgpack")
CHIP_ACTOR = os.path.join(REPO, "chip_inputs", "sac_cfg5_15000_actor.npz")
ATOL = 2e-2
CFG_KW = dict(discrete_actions=False, use_raw_pixels=True, num_cameras=1, obs_pool=2,
              obs_samples=0)
HIDDEN = (32, 16)
B = 16
LR_A, LR_C, LR_ALPHA = 1e-4, 1e-3, 3e-4
TAU, GAMMA = 0.005, 0.99
CASES = {
    "sac": dict(),
    "drq": dict(aug_shift=2, reward_scale=0.1, grad_clip=1.0),
    "recipe": dict(aug_shift=2, reward_scale=0.1, grad_clip=10.0),
}
# Each case's config, networks, batch, learning rates and temperature floor.
TOY = dict(cfg_kw=CFG_KW, encoder="dense", hidden=HIDDEN, b=B, lr_a=LR_A, lr_c=LR_C,
           alpha_min=None)
SHAPES = {
    "sac": TOY,
    "drq": TOY,
    # scripts/torch_sac_pixels.py's recipe as the card trains it: the conv
    # encoder, 2 cameras, obs_pool 2 over 50x50 renders, the default hidden
    # widths, its learning rates and --alpha-min 0.02.  The only cut: a batch
    # of 32 for its 256.
    "recipe": dict(cfg_kw=dict(CFG_KW, num_cameras=2), encoder="conv", hidden=(100, 50), b=32,
                   lr_a=1e-4, lr_c=3e-4, alpha_min=0.02),
}


def _t(x):
    return torch.from_numpy(np.array(x))


class _Heads:
    """An actor for the JAX ``sample_action`` whose params are its output."""

    def apply(self, params, obs):
        return params


def test_sample_action_matches_jax():
    """The same (mu, log_std) and standard normals, pre-squash |u| up to 15
    (tanh saturated, where log(1 − tanh²) needs the stable identity)."""
    rng = np.random.default_rng(0)
    n = 4096
    mu = rng.uniform(-15.0, 15.0, (n, 2)).astype(np.float32)
    mu[:8] = [[15.0, -15.0], [14.9, -14.9], [10.0, -10.0], [9.5, 0.0], [0.0, 0.0],
              [1e-3, -1e-3], [5.0, -5.0], [12.0, 3.0]]
    log_std = rng.uniform(-20.0, 2.0, (n, 2)).astype(np.float32)
    log_std[:8] = -20.0
    key = jax.random.PRNGKey(7)
    a_j, logp_j = jsac.sample_action(_Heads(), (jnp.asarray(mu), jnp.asarray(log_std)), None, key)
    eps = _t(jax.random.normal(key, mu.shape))
    a, logp = sac.sample_action(lambda obs: (_t(mu), _t(log_std)), None, eps=eps)
    u = _t(mu) + torch.exp(_t(log_std)) * eps
    assert float(u.abs().max()) > 14.9
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), rtol=0, atol=1e-4)
    assert bool(torch.isfinite(logp).all())
    # Drawn from a generator when eps is not given: the same shapes.
    a2, logp2 = sac.sample_action(lambda obs: (_t(mu), _t(log_std)), None,
                                  generator=torch.Generator().manual_seed(0))
    assert a2.shape == (n, 2) and logp2.shape == (n,)


def _randomize(params, seed, head_std=1.0):
    """Every leaf from a seeded normal of std 1/√fan_in (biases 0.1), the
    heads of std ``head_std``: flax's init would leave the heads near 0."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        x = np.asarray(x)
        names = [p.key for p in path]
        if names[-1] == "bias":
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        std = head_std if names[-2] in ("mu", "log_std") else 1.0 / np.sqrt(np.prod(x.shape[:-1]))
        return (std * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("encoder,side,cams", [("dense", 25, 1), ("conv", 25, 2),
                                               ("conv", 50, 1)])
def test_gaussian_actor_matches_flax(encoder, side, cams):
    obs = np.random.default_rng(1).integers(0, 256, (6, 2, cams * 3 * side * side),
                                            dtype=np.uint8)
    kw = dict(use_raw_pixels=True, hidden=HIDDEN, pixel_encoder=encoder, height=side, width=side)
    jactor = JGaussianActor(action_dim=2, **kw)
    params = _randomize(jactor.init(jax.random.PRNGKey(2), jnp.zeros(obs.shape)), side + cams)
    mu_j, ls_j = (np.asarray(x) for x in jactor.apply(params, jnp.asarray(obs)))
    actor = GaussianActor(obs.shape[1:], device="cpu", **kw)
    actor.load_state_dict(gaussian_actor_params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        mu, ls = actor(_t(obs))
    assert mu.shape == ls.shape == (6, 2)
    assert np.abs(mu_j).max() > 0.5 and ls_j.min() < ls_j.max()
    for got, want in ((mu, mu_j), (ls, ls_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()))
    # The clamp of log_std: a head pushed far out reads the bounds.
    with torch.no_grad():
        actor.log_std.bias.fill_(100.0)
        assert float(actor(_t(obs))[1].max()) == 2.0
        actor.log_std.bias.fill_(-100.0)
        assert float(actor(_t(obs))[1].min()) == -20.0


def _batch(cfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    shape = (b, *cfg.obs_shape)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.uniform(-1, 1, (b, 2)).astype(np.float32),
            rng.normal(size=b).astype(np.float32),
            rng.integers(0, 256, shape, dtype=np.uint8),
            rng.random(b) < 0.25)


def _draws(k_train, hp, b=B):
    """The draws a JAX SAC train_once makes from ``k_train``: the target's
    and the actor's normals and the shift offsets of s1 and s2."""
    k_next, k_new, k_aug = jax.random.split(k_train, 3)
    eps_next, eps_new = (_t(jax.random.normal(k, (b, 2))) for k in (k_next, k_new))
    pad = hp.get("aug_shift", 0)
    offsets = None
    if pad:
        offsets = tuple(_t(jax.random.randint(k, (b, 2), 0, 2 * pad + 1))
                        for k in jax.random.split(k_aug))
    return dict(eps_next=eps_next, eps_new=eps_new, aug_offsets=offsets)


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _one_update(name, log_alpha_min=None):
    """One JAX SAC train_once (from make_segment's closure) and the same
    update in the port, from the same params, batch and draws; the case's
    temperature floor where ``log_alpha_min`` is not given."""
    hp, shape = CASES[name], SHAPES[name]
    b, lr_a, lr_c = shape["b"], shape["lr_a"], shape["lr_c"]
    if log_alpha_min is None and shape["alpha_min"]:
        log_alpha_min = float(np.log(shape["alpha_min"]))
    jcfg, cfg = JConfig(**shape["cfg_kw"]), CartpoleConfig(**shape["cfg_kw"])
    kw = dict(use_raw_pixels=True, hidden=shape["hidden"], pixel_encoder=shape["encoder"],
              height=cfg.obs_height, width=cfg.obs_width)
    jactor, jcritic = JGaussianActor(action_dim=2, **kw), JCritic(**kw)
    k_a, k_c, k_train = jax.random.split(jax.random.PRNGKey(13), 3)
    dummy_obs, dummy_act = jnp.zeros((2,) + jcfg.obs_shape), jnp.zeros((2, 2))
    actor_vars = dict(jax.jit(jactor.init)(k_a, dummy_obs))
    critic_vars = {"params": jax.jit(jax.vmap(
        lambda k: jcritic.init(k, dummy_obs, dummy_act)["params"]))(jax.random.split(k_c, 2))}
    clip = hp.get("grad_clip", 0.0)
    tx = (lambda lr: optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))) if clip \
        else optax.adam
    atx, ctx, altx = tx(lr_a), tx(lr_c), optax.adam(LR_ALPHA)
    seg = jsac.make_segment(
        jcommon.make_venv(jcfg, 4), jactor, jcritic, atx, ctx, altx, gamma=GAMMA, tau=TAU,
        batch_size=b, warmup_steps=0, steps_per_segment=1, target_entropy=-2.0,
        log_alpha_min=log_alpha_min, reward_scale=hp.get("reward_scale", 1.0),
        aug_shift=hp.get("aug_shift", 0))
    train_once = _closure(seg)["train_once"]
    fns = _closure(train_once)
    log_alpha = jnp.log(jnp.asarray(0.1, jnp.float32))
    bundle = (actor_vars, critic_vars, critic_vars, atx.init(actor_vars["params"]),
              ctx.init(critic_vars["params"]), log_alpha, altx.init(log_alpha))
    batch = _batch(cfg, b=b)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    new_bundle, metrics = jax.jit(train_once)(bundle, jbatch, k_train)

    # JAX's gradients at the update's own inputs, from its loss functions.
    s1, s2 = (x.astype(jnp.float32) / 255.0 for x in (jbatch[0], jbatch[3]))
    k_next, k_new, k_aug = jax.random.split(k_train, 3)
    pad = hp.get("aug_shift", 0)
    if pad:
        k1, k2 = jax.random.split(k_aug)
        s1 = fns["aug_random_shift"](s1, k1, pad, cfg.obs_height, cfg.obs_width)
        s2 = fns["aug_random_shift"](s2, k2, pad, cfg.obs_height, cfg.obs_width)
    alpha = jnp.exp(log_alpha)
    a2, logp2 = jsac.sample_action(jactor, actor_vars, s2, k_next)
    q2 = jnp.min(jax.vmap(lambda p: jcritic.apply({"params": p}, s2, a2))(critic_vars["params"]),
                 axis=0)
    y = hp.get("reward_scale", 1.0) * jbatch[2] + GAMMA * (1.0 - jbatch[4]) * (q2 - alpha * logp2)
    cgrads = jax.jit(jax.grad(fns["critic_loss_fn"]))(critic_vars["params"], s1, jbatch[1], y)
    agrads = jax.jit(jax.grad(lambda p: fns["actor_loss_fn"](p, new_bundle[1]["params"], alpha,
                                                             s1, k_new)[0]))(actor_vars["params"])
    if clip:
        clip_fn = optax.clip_by_global_norm(clip)
        cgrads = clip_fn.update(cgrads, clip_fn.init(cgrads))[0]
        agrads = clip_fn.update(agrads, clip_fn.init(agrads))[0]

    # The port, from the same params.
    actor = GaussianActor(cfg.obs_shape, device="cpu", **kw)
    critic = TwinCritic(cfg.obs_shape, device="cpu", **kw)
    actor.load_state_dict(gaussian_actor_params_from_flax(jax.device_get(actor_vars)))
    critic.load_state_dict(critic_params_from_flax(jax.device_get(critic_vars)))
    (aopt, asch), (copt, csch) = ddpg.adam(actor, lr_a), ddpg.adam(critic, lr_c)
    la = torch.log(torch.tensor(0.1, dtype=torch.float32)).requires_grad_(True)
    st = sac.SACState(
        actor=actor, critic=critic, target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=aopt, critic_opt=copt, actor_sched=asch, critic_sched=csch, log_alpha=la,
        alpha_opt=torch.optim.Adam([la], lr=LR_ALPHA), replay=None, env_states=None, obs=None,
        generator=torch.Generator().manual_seed(0))
    target0 = {k: v.clone() for k, v in st.target_critic.state_dict().items()}
    port_once = sac.make_train_once(cfg, gamma=GAMMA, tau=TAU, target_entropy=-2.0,
                                    log_alpha_min=log_alpha_min, **hp)
    got = port_once(st, tuple(_t(x) for x in batch), **_draws(k_train, hp, b))
    return SimpleNamespace(name=name, hp=hp, b=b, lr_a=lr_a, lr_c=lr_c, cfg=cfg, st=st, got=got,
                           metrics=metrics,
                           new_bundle=new_bundle, cgrads=cgrads, agrads=agrads,
                           target0=target0, port_once=port_once, train_once=train_once,
                           log_alpha0=float(log_alpha))


@pytest.fixture(scope="module", params=list(CASES))
def update(request):
    return _one_update(request.param)


def test_train_once_metrics_match_jax(update):
    for k in ("critic_loss", "actor_loss", "alpha", "entropy"):
        assert float(update.got[k]) == pytest.approx(float(update.metrics[k]), rel=2e-2), k
    assert float(update.got["critic_loss"]) > 0.0


def _sums_in_bf16_on_jax_cpu(name, key):
    """A conv trunk's bias at the recipe's shape, whose JAX reference
    gradient is summed in bfloat16."""
    return name == "recipe" and ".conv_trunk." in key and key.endswith(".bias")


def test_train_once_gradients_match_jax(update):
    want = {**{"a." + k: v for k, v in gaussian_actor_params_from_flax(update.agrads).items()},
            **{"c." + k: v for k, v in critic_params_from_flax(update.cgrads).items()}}
    got = {**{"a." + k: p.grad for k, p in update.st.actor.named_parameters()},
           **{"c." + k: p.grad for k, p in update.st.critic.named_parameters()}}
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert bool(torch.isfinite(got[k]).all()) and float(got[k].abs().max()) > 0.0, k
        if _sums_in_bf16_on_jax_cpu(update.name, k):
            continue
        rel = float(torch.linalg.vector_norm(got[k] - w) / torch.linalg.vector_norm(w))
        assert rel <= 5e-2, f"{k}: relative gradient error {rel:.3g}"


def test_jax_cpu_sums_a_bf16_bias_add_gradient_in_bf16():
    """The gradient of a bfloat16 bias add over (32, 13, 13, 16), the
    recipe's first conv output at batch 32: JAX on the CPU sums it in
    bfloat16, the port (PyTorch) in float32, against the exact sum of the
    same bfloat16 cotangent."""
    c = np.random.default_rng(3).normal(size=(32, 13, 13, 16)).astype(np.float32)
    cb = jnp.asarray(c).astype(jnp.bfloat16)
    exact = np.asarray(cb.astype(jnp.float32), np.float64).sum((0, 1, 2))

    def loss(b):
        y = jnp.zeros(c.shape, jnp.bfloat16) + b.astype(jnp.bfloat16)
        return jnp.sum((y * cb).astype(jnp.float32))

    g_jax = np.asarray(jax.grad(loss)(jnp.zeros(16, jnp.float32)), np.float64)
    bias = torch.zeros(16, requires_grad=True)
    ct = _t(np.asarray(cb.astype(jnp.float32))).permute(0, 3, 1, 2)  # NCHW, as ConvTrunk
    y = torch.zeros(ct.shape, dtype=torch.bfloat16) + bias.to(torch.bfloat16)[:, None, None]
    (y.float() * ct).sum().backward()
    rel = lambda g: float(np.linalg.norm(g - exact) / np.linalg.norm(exact))
    gaps = rel(g_jax), rel(bias.grad.numpy().astype(np.float64))
    print(f"bias-add gradient off the exact sum: JAX {gaps[0]:.4f}, port {gaps[1]:.5f}")
    assert gaps[0] > 5e-2
    assert gaps[1] < 5e-3


def test_train_once_params_match_jax_after_adam(update):
    new_a, new_c = update.new_bundle[0], update.new_bundle[1]
    for module, tree, conv, lr in (
            (update.st.actor, new_a, gaussian_actor_params_from_flax, update.lr_a),
            (update.st.critic, new_c, critic_params_from_flax, update.lr_c)):
        want = conv(jax.device_get(tree))
        flipped = total = 0
        for k, v in module.state_dict().items():
            gap = (v - want[k]).abs()
            assert float(gap.max()) <= 2 * lr + 1e-6, f"{k}: {float(gap.max()):.3g} beyond 2·lr"
            flipped += int((gap > lr).sum())
            total += gap.numel()
        assert flipped / total <= 1e-4
    la, la_j = float(update.st.log_alpha.detach()), float(update.new_bundle[5])
    assert la != update.log_alpha0
    assert abs(la - la_j) <= 2 * LR_ALPHA + 1e-6


def test_train_once_target_critic_moves_by_tau(update):
    """target ← target + τ·(critic − target) over the port's updated
    critic, and within τ·2·lr of JAX's target."""
    st = update.st
    want_jax = critic_params_from_flax(jax.device_get(update.new_bundle[2]))
    online = st.critic.state_dict()
    for k, v in st.target_critic.state_dict().items():
        step = update.target0[k] + TAU * (online[k] - update.target0[k])
        np.testing.assert_allclose(v.numpy(), step.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), want_jax[k].numpy(), rtol=0,
                                   atol=TAU * 2 * update.lr_c + 1e-6)
        assert not torch.equal(v, update.target0[k])


@pytest.fixture(scope="module", params=[c for c in CASES if c != "recipe"])
def two_updates(request):
    u = _one_update(request.param)
    batch = _batch(u.cfg, seed=1, b=u.b)
    key = jax.random.PRNGKey(14)
    bundle, metrics = jax.jit(u.train_once)(u.new_bundle, tuple(jnp.asarray(x) for x in batch), key)
    got = u.port_once(u.st, tuple(_t(x) for x in batch), **_draws(key, u.hp, u.b))
    return SimpleNamespace(u=u, bundle=bundle, metrics=metrics, got=got)


def test_train_once_params_match_jax_after_two_updates(two_updates):
    t, u = two_updates, two_updates.u
    assert float(t.got["critic_loss"]) == pytest.approx(float(t.metrics["critic_loss"]), rel=2e-2)
    gaps = {}
    for prefix, module, tree, conv, lr in (
            ("a.", u.st.actor, t.bundle[0], gaussian_actor_params_from_flax, u.lr_a),
            ("c.", u.st.critic, t.bundle[1], critic_params_from_flax, u.lr_c)):
        want = conv(jax.device_get(tree))
        gaps[prefix] = max(float((v - want[k]).abs().max()) / lr
                           for k, v in module.state_dict().items())
    gaps["log_alpha"] = abs(float(u.st.log_alpha.detach()) - float(t.bundle[5])) / LR_ALPHA
    print(f"{u.name}: largest gap after two updates, in lr: {gaps}")
    assert all(g <= 1.0 for g in gaps.values()), gaps


def test_alpha_floor_clamps_like_jax():
    """--alpha-min above the current α: the update's log α is the floor's,
    in the port as in JAX, and the metric reads the floor."""
    floor = float(np.log(0.2))
    u = _one_update("sac", log_alpha_min=floor)
    assert float(u.st.log_alpha.detach()) == float(u.new_bundle[5]) == float(np.float32(floor))
    assert float(u.got["alpha"]) == pytest.approx(0.2, rel=1e-6)
    assert float(u.metrics["alpha"]) == pytest.approx(0.2, rel=1e-6)


def test_segment_metrics_and_gate():
    """Segments of the plain versions: no update and zero metrics (alpha
    reads 0) before the gate opens, then SAC's metrics once it has."""
    from cartpoleplusplus_tpu_torch.agents.common import make_venv

    cfg = CartpoleConfig(discrete_actions=False, max_episode_len=3)
    venv = make_venv(cfg, 16, device="cpu")
    st = sac.init_state(SimpleNamespace(seed=0, replay_capacity=64, init_alpha=0.1), cfg, venv,
                        hidden=HIDDEN)
    assert float(st.log_alpha.detach()) == float(np.log(np.float32(0.1)))
    hp = dict(gamma=GAMMA, tau=TAU, batch_size=8, warmup_steps=2, target_entropy=-2.0)
    first = sac.make_segment(venv, steps_per_segment=2, **hp)(st)
    assert first["updates"] == 0
    assert all(float(first[k]) == 0.0 for k in sac.METRIC_KEYS)
    second = sac.make_segment(venv, steps_per_segment=2, **hp)(st)
    assert second["updates"] == 2 and st.env_steps == 4 and st.replay.size == 64
    assert 0.0 < float(second["alpha"]) < 0.1 + 1e-3
    assert all(np.isfinite(float(second[k])) for k in (*sac.METRIC_KEYS, "reward",
                                                       "double_reset_frac"))


@pytest.fixture(scope="module")
def checkpoint():
    with open(CKPT, "rb") as f:
        jraw = serialization.msgpack_restore(f.read())
    return jraw, sac_params_from_jax_checkpoint(CKPT)


def test_checkpoint_greedy_actions_match_flax(checkpoint):
    """The config-5 SAC checkpoint's actor, read without flax, against flax
    on the checkpoint's own 512 carried observations; its twin critics'
    Q on those actions too."""
    jraw, port = checkpoint
    cfg = CartpoleConfig(discrete_actions=False, use_raw_pixels=True, num_cameras=2, obs_pool=2,
                         obs_samples=2)
    kw = dict(use_raw_pixels=True, pixel_encoder="conv", height=cfg.obs_height,
              width=cfg.obs_width)
    jactor, jcritic = JGaussianActor(action_dim=2, **kw), JCritic(**kw)
    obs = np.asarray(jraw["obs"])
    assert obs.shape == (512, *cfg.obs_shape) and torch.equal(port["obs"], _t(obs))
    a_j = np.asarray(jsac.greedy_act(jactor)(jraw["actor_params"], jnp.asarray(obs)))
    q_j = np.asarray(jax.vmap(lambda p: jcritic.apply({"params": p}, jnp.asarray(obs),
                                                      jnp.asarray(a_j)))(
        jraw["critic_params"]["params"]))
    actor = GaussianActor(cfg.obs_shape, device="cpu", **kw)
    actor.load_state_dict(port["actor"])
    critic = TwinCritic(cfg.obs_shape, device="cpu", **kw)
    critic.load_state_dict(port["critic"])
    a = sac.greedy_act(actor)(port["obs"])
    with torch.no_grad():
        q = critic(port["obs"], _t(a_j))
    np.testing.assert_allclose(a.numpy(), a_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(q.numpy(), q_j, rtol=0, atol=ATOL * max(1.0, np.abs(q_j).max()))
    assert float(port["log_alpha"]) == float(np.asarray(jraw["log_alpha"]))
    assert port["env_steps"] == int(np.asarray(jraw["env_steps"])) == 375000
    TwinCritic(cfg.obs_shape, device="cpu", **kw).load_state_dict(port["target_critic"])


def test_chip_actor_npz_equals_checkpoint(checkpoint):
    """chip_inputs' npz holds the checkpoint's actor leaves, leaf for leaf
    and byte for byte, and maps to the same state_dict."""
    jraw, port = checkpoint
    want = flatten_tree(jax.tree.map(np.asarray, jraw["actor_params"]))
    with np.load(CHIP_ACTOR) as z:
        got = {k: z[k] for k in z.files}
    assert got.keys() == want.keys() and len(got) == 14
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
    sd = gaussian_actor_params_from_flax(unflatten_tree(got))
    assert sd.keys() == port["actor"].keys()
    assert all(torch.equal(sd[k], port["actor"][k]) for k in sd)
    assert flatten_tree(flax_msgpack.load(CKPT)["actor_params"]).keys() == want.keys()


# The resume and floor tests drive the port's ``train`` on the CPU at a toy
# size (4 low-dim envs, 3 steps a segment), as tests/test_torch_checkpoint.py
# does for DDPG.
def _opts(ckpt_dir, n, *extra):
    return sac.make_parser().parse_args([
        "--device", "cpu", "--num-train-batches", str(n), "--num-envs", "4", "--num-eval", "4",
        "--action-repeats", "2", "--steps-per-repeat", "2", "--max-episode-len", "10",
        "--steps-per-segment", "3", "--batch-size", "4", "--replay-capacity", "64",
        "--warmup-steps", "1", "--seed", "0", "--eval-freq", "100",
        "--ckpt-dir", str(ckpt_dir), "--ckpt-freq", "1", *extra])


def _equal(a, b, path=""):
    """Nested dicts of tensors and host values equal, tensors byte for byte."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape, path
        as_bytes = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
        assert torch.equal(as_bytes(a), as_bytes(b)), path
    else:
        assert a == b, path


def test_sac_agent_resume(tmp_path):
    """The counterpart of tests/test_checkpoint.py::test_sac_agent_resume:
    the checkpoint carries log_alpha and alpha_opt, and a resume continues
    the segment numbering and the env steps."""
    from cartpoleplusplus_tpu_torch.utils import checkpoint as ckpt

    sac.train(_opts(tmp_path, 2))
    assert ckpt.latest_step(str(tmp_path)) == 2
    raw1 = ckpt.load_raw(str(tmp_path), 2)
    assert "log_alpha" in raw1 and "alpha_opt" in raw1
    assert raw1["log_alpha"].shape == () and raw1["alpha_opt"]["state"]
    assert int(raw1["env_steps"]) == 2 * 3
    sac.train(_opts(tmp_path, 4))
    assert ckpt.latest_step(str(tmp_path)) == 4
    raw2 = ckpt.load_raw(str(tmp_path), 4)
    assert int(raw2["env_steps"]) == 2 * 3 + 2 * 3
    assert float(raw2["log_alpha"]) != float(raw1["log_alpha"])


@pytest.mark.parametrize("extra", [(), ("--lr-schedule", "cosine", "--grad-clip", "10",
                                        "--alpha-min", "0.09")])
def test_resume_is_exact(tmp_path, extra):
    """A run of 4 segments resumed from its own ckpt_2 ends in the state it
    ended in, byte for byte: networks, target, optimizers, schedules,
    log_alpha and its optimizer, replay, env states, obs and generator."""
    from cartpoleplusplus_tpu_torch.utils import checkpoint as ckpt
    import shutil

    sac.train(_opts(tmp_path / "once", 4, *extra))
    os.makedirs(tmp_path / "resumed")
    shutil.copy(tmp_path / "once" / "ckpt_2.pt", tmp_path / "resumed" / "ckpt_2.pt")
    sac.train(_opts(tmp_path / "resumed", 4, *extra))
    once = ckpt.load_raw(str(tmp_path / "once"), 4)
    _equal(once, ckpt.load_raw(str(tmp_path / "resumed"), 4))
    assert once["replay"]["size"] == 4 * 3 * 4 and once["replay"]["priority"].shape == (0,)


def test_sac_alpha_floor_clamps(tmp_path):
    """The counterpart of tests/test_learning.py::test_sac_alpha_floor_clamps,
    same flags: every trained segment's α at or above a floor set far above
    its start."""
    import json
    import shlex

    smoke = shlex.split("""--num-envs 32 --num-eval 32 --action-repeats 2 --steps-per-repeat 3
      --max-episode-len 60 --eval-freq 20 --steps-per-segment 25 --batch-size 64
      --replay-capacity 4096 --warmup-steps 10 --seed 0""")
    jsonl = tmp_path / "sac.jsonl"
    sac.main(["--device", "cpu", "--num-train-batches", "6", "--eval-freq", "2",
              "--init-alpha", "0.05", "--alpha-min", "0.5", "--metrics-jsonl", str(jsonl),
              *smoke])
    alphas = [json.loads(line)["alpha"] for line in open(jsonl)
              if json.loads(line).get("event") == "train"]
    trained = [a for a in alphas if a > 0.0]
    assert trained, "no trained segments logged"
    assert min(trained) >= 0.5 - 1e-6, f"alpha floor violated: {trained}"

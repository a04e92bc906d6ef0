"""The port's LRPG against the JAX package on the CPU: the
``DiscretePolicy`` (dense low-dim, dense and conv pixels) with params
carried across by ``utils/params.py``, and its init; the greedy argmax;
``discounted_returns``; ``loss_fn`` and its gradients; one whole update
against the JAX ``make_train_step``'s ``train_step``, fed JAX's draws (the
reset's push directions and tilts, and the Gumbel noise that
``jax.random.categorical`` adds to the logits).

Tolerances, as ROADMAP's parity rules set them: logits 2e-2 of their
scale (the bf16 bound); returns 1e-6 of their scale (the same float32
recurrence); physics as tests/test_torch_slice.py holds it; the sampled
actions, rewards and valid masks equal; the loss rtol 2e-2 and its
gradients ≤ 5e-2 in relative norm per parameter; the params after the
update's one Adam step within 2·lr (+1e-6) of JAX's, at most 1e-4 of
them more than lr away (Adam's first step moves each parameter by
lr·g/(|g| + ε), so only a bf16-flipped gradient sign moves it further).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import lrpg as jlrpg
from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.models import DiscretePolicy as JDiscretePolicy
from cartpoleplusplus_tpu_torch.agents import common, lrpg
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.models.networks import DiscretePolicy
from cartpoleplusplus_tpu_torch.utils.params import discrete_policy_params_from_flax

torch.set_num_threads(2)

ATOL = 2e-2
HIDDEN = (16, 16)
E = 16
LR = 1e-3
GAMMA = 0.99
# Low-dim, discrete actions, 16 envs, 10-step episodes (T = 10).
CFG_KW = dict(discrete_actions=True, use_raw_pixels=False, max_episode_len=10)
STATE_TOL = {"pos": (1e-5, 0.0), "quat": (1e-5, 0.0), "vel": (1e-5, 0.0), "ang": (1e-4, 1e-4)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomize(params, seed):
    """Every leaf from a seeded normal of std 1/√fan_in, biases 0.1."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        x = np.asarray(x)
        if path[-1].key == "bias":
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return (rng.normal(size=x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _obs(encoder, side, cams, n=6, seed=1):
    rng = np.random.default_rng(seed)
    if encoder == "lowdim":
        return rng.normal(size=(n, 3, 2, 7)).astype(np.float32), dict(use_raw_pixels=False)
    obs = rng.integers(0, 256, (n, 2, cams * 3 * side * side), dtype=np.uint8)
    return obs, dict(use_raw_pixels=True, pixel_encoder=encoder, height=side, width=side)


@pytest.mark.parametrize("encoder,side,cams", [("lowdim", 0, 0), ("dense", 25, 1),
                                               ("conv", 25, 2)])
def test_discrete_policy_matches_flax(encoder, side, cams):
    """Logits within the bf16 bound; the greedy argmax equal wherever JAX's
    top two logits are further apart than that bound."""
    obs, kw = _obs(encoder, side, cams, n=64)
    jpolicy = JDiscretePolicy(num_actions=5, hidden=HIDDEN, **kw)
    params = _randomize(jpolicy.init(jax.random.PRNGKey(2), jnp.zeros(obs.shape)), side + cams)
    want = np.asarray(jpolicy.apply(params, jnp.asarray(obs)))
    policy = DiscretePolicy(obs.shape[1:], hidden=HIDDEN, device="cpu", **kw)
    policy.load_state_dict(discrete_policy_params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = policy(_t(obs))
    assert got.shape == want.shape == (64, 5)
    bound = ATOL * np.abs(want).max()
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)
    act = lrpg.greedy_act(policy)(_t(obs)).numpy()
    jact = np.asarray(jlrpg.greedy_act(jpolicy)(params, jnp.asarray(obs)))
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * bound
    assert clear.sum() >= 32
    np.testing.assert_array_equal(act[clear], jact[clear])


def test_discrete_policy_init_like_flax():
    """The head ``logits`` is a plain Dense: LeCun normal, zero bias (not
    the final-layer init), so the untrained policy's logits are O(1)."""
    policy = DiscretePolicy((3, 2, 7), hidden=(64, 256), device="cpu",
                            generator=torch.Generator().manual_seed(0)).requires_grad_(False)
    assert float(policy.logits.bias.abs().max()) == 0.0
    assert abs(float(policy.logits.weight.std()) * np.sqrt(256) - 1.0) < 0.1
    logits = policy(torch.randn((256, 3, 2, 7), generator=torch.Generator().manual_seed(1)))
    assert float(logits.std()) > 0.1


def test_discounted_returns_match_jax():
    rng = np.random.default_rng(3)
    t, e = 20, 12
    rew = rng.uniform(0.0, 1.0, (t, e)).astype(np.float32)
    ends = rng.integers(1, t + 1, e)
    valid = (np.arange(t)[:, None] < ends[None, :]).astype(np.float32)
    want = np.asarray(jlrpg.discounted_returns(jnp.asarray(rew), jnp.asarray(valid), GAMMA))
    got = lrpg.discounted_returns(_t(rew), _t(valid), GAMMA).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert (got[valid == 0] == 0).all()


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@pytest.fixture(scope="module")
def update():
    """One JAX LRPG train_step and the port's, from the same params and
    draws, and the JAX ``rollout_batch`` beside the port's."""
    jcfg, cfg = JConfig(**CFG_KW), CartpoleConfig(**CFG_KW)
    jvenv = jcommon.make_venv(jcfg, E)
    jpolicy = JDiscretePolicy(num_actions=5, use_raw_pixels=False, hidden=HIDDEN)
    k_init, rng = jax.random.split(jax.random.PRNGKey(21))
    params = jpolicy.init(k_init, jnp.zeros((1,) + jcfg.obs_shape))
    tx = optax.adam(LR)
    ts = jlrpg.TrainState(params=params, opt_state=tx.init(params), rng=rng,
                          update=jnp.zeros((), jnp.int32))
    train_step = jlrpg.make_train_step(jvenv, jpolicy, tx, GAMMA)
    new_ts, metrics = jax.jit(train_step)(ts)

    # JAX's draws, split as train_step and rollout_batch split them.
    T = jcfg.max_episode_len
    _, k_roll = jax.random.split(rng)
    k_reset, k_steps = jax.random.split(k_roll)
    k_theta, k_jitter = jax.random.split(k_reset)
    theta = jax.random.uniform(k_theta, (E,), minval=0.0, maxval=2.0 * jnp.pi)
    jitter = jax.random.normal(k_jitter, (E, 2))
    keys = jax.random.split(k_steps, T)
    noise = jnp.stack([jax.random.gumbel(k, (E, 5)) for k in keys])
    jroll = jax.jit(lambda: jlrpg.rollout_batch(jvenv, jpolicy, params, k_roll))()
    jlogits = jax.vmap(lambda o: jpolicy.apply(params, o))(jroll[0])
    jret = jlrpg.discounted_returns(jroll[2], jroll[3].astype(jnp.float32), GAMMA)
    loss_fn = _closure(train_step)["loss_fn"]
    jloss, jgrads = jax.value_and_grad(loss_fn)(params, *jroll[:2], jret, jroll[3])

    venv = common.make_venv(cfg, E, device="cpu")
    sd = discrete_policy_params_from_flax(jax.device_get(params))

    def port_state():
        policy = DiscretePolicy(cfg.obs_shape, hidden=HIDDEN, device="cpu")
        policy.load_state_dict(sd)
        return lrpg.LRPGState(policy=policy, opt=torch.optim.Adam(policy.parameters(), lr=LR),
                              generator=torch.Generator().manual_seed(0))

    draws = dict(noise=_t(noise), reset=(_t(theta), _t(jitter)))
    st = port_state()
    roll = lrpg.rollout_batch(venv, st.policy, st.generator, **draws)
    # The loss and gradients on JAX's own batch.
    loss = lrpg.loss_fn(st.policy, *(_t(x) for x in jroll[:2]), _t(jret), _t(jroll[3]))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in st.policy.named_parameters()}
    st = port_state()
    got = lrpg.make_train_step(venv, GAMMA)(st, **draws)
    return SimpleNamespace(jroll=jroll, jlogits=jlogits, noise=noise, keys=keys, roll=roll,
                           jloss=jloss, jgrads=jgrads, loss=loss, grads=grads, new_ts=new_ts,
                           metrics=metrics, st=st, got=got)


def test_categorical_is_gumbel_argmax(update):
    """On the JAX side: every action ``rollout_batch`` sampled with
    ``jax.random.categorical`` is the argmax of its logits plus the Gumbel
    noise drawn from the same key, the noise the port is fed."""
    for t, k in enumerate(update.keys):
        want = np.asarray(jax.random.categorical(k, update.jlogits[t]))
        np.testing.assert_array_equal(np.asarray(update.jroll[1][t]), want)
        np.testing.assert_array_equal(
            np.asarray(jnp.argmax(update.jlogits[t] + update.noise[t], axis=-1)), want)


def test_rollout_matches_jax(update):
    """The port's rollout given JAX's draws: the sampled actions equal,
    every action taken at least once, rewards and valid masks equal, the
    obs within the physics tolerance."""
    obs, act, rew, valid = update.roll
    jobs, jact, jrew, jvalid = (np.asarray(x) for x in update.jroll)
    assert act.dtype == torch.int64 and tuple(act.shape) == jact.shape == (10, E)
    np.testing.assert_array_equal(act.numpy(), jact)
    assert set(np.unique(jact)) == set(range(5))
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(rew.numpy(), jrew)
    assert not jvalid.all() and jvalid[0].all()
    np.testing.assert_allclose(obs.numpy(), jobs, rtol=0, atol=1e-5)


def test_loss_and_grads_match_jax(update):
    np.testing.assert_allclose(float(update.loss.detach()), float(update.jloss), rtol=2e-2)
    want = discrete_policy_params_from_flax(jax.device_get(update.jgrads))
    for n, g in update.grads.items():
        rel = float(torch.linalg.norm(g - want[n]) / max(float(torch.linalg.norm(want[n])), 1e-12))
        assert rel <= 5e-2, (n, rel)


def test_update_matches_jax(update):
    """The whole update: loss rtol 2e-2, episode length and reward equal,
    the params after the Adam step within 2·lr, at most 1e-4 of them more
    than lr away (``-s`` prints the largest gap in lr); ``update``
    advanced."""
    got, want = update.got, update.metrics
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-2)
    assert float(got["ep_len"]) == float(want["ep_len"])
    assert float(got["ep_rew"]) == pytest.approx(float(want["ep_rew"]), rel=1e-6)
    new = discrete_policy_params_from_flax(jax.device_get(update.new_ts.params))
    gap = torch.cat([((p.detach() - new[n]).abs() / LR).reshape(-1)
                     for n, p in update.st.policy.named_parameters()])
    print("largest gap in lr:", float(gap.max()))
    assert float(gap.max()) <= 2.0 + 1e-6 / LR
    assert float((gap > 1.0).to(torch.float32).mean()) <= 1e-4
    assert update.st.update == 1 and int(update.new_ts.update) == 1

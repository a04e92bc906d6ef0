"""The port's DQN against the JAX package on the CPU: ``NoisyLinear`` against
flax's ``NoisyDense`` on the normals JAX draws (recorded by wrapping
``jax.random.normal`` around an unjitted ``apply``), the ``QNetwork`` on its
8 head combinations (dueling × C51 × noisy) with the low-dim and the conv
encoder, the C51 projection, one ``train_once`` against the JAX
``make_segment``'s own ``train_once`` fed the same batch and the same
NoisyNet draws (no double-Q, double-Q, dueling, C51 and the full Rainbow:
C51 + dueling + noisy with PER weights on an n-step batch), two Rainbow
updates, the training segment's bookkeeping (torch only), and the JAX
Rainbow checkpoint read without flax.

Tolerances, as ``tests/test_torch_ddpg.py`` sets them and why:
- ``NoisyLinear``: 1e-5 (float32 on both sides, the same noise);
- the ``QNetwork``'s outputs and the C51 means: 2e-2 of their scale, the
  bf16 encoder's bound;
- the projection: 1e-6 (the same float32 arithmetic);
- losses rtol 2e-2, gradients ≤ 5e-2 in relative norm per parameter (JAX's
  are read off Adam's first moment, ``mu = (1 − β1)·g``), the priorities
  (|td| or the cross-entropy) within the loss bound, 2e-2 of their scale;
- params after one Adam step within 2·lr (+1e-6), at most 1e-4 of the
  entries more than lr away; after two updates 1·lr;
- targets: the polyak step over the port's own params at 1e-6, and within
  τ·2·lr + 1e-6 of JAX's.
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
from cartpoleplusplus_tpu.agents import dqn as jdqn
from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.models import NoisyDense as JNoisyDense
from cartpoleplusplus_tpu.models import QNetwork as JQNetwork
from cartpoleplusplus_tpu_torch.agents import ddpg, dqn
from cartpoleplusplus_tpu_torch.agents.common import make_venv
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.models.networks import NoisyLinear, QNetwork
from cartpoleplusplus_tpu_torch.utils.params import (
    dqn_params_from_jax_checkpoint,
    flatten_tree,
    q_network_params_from_flax,
    unflatten_tree,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "runs", "ckpt_dqn_rainbow", "ckpt_50000.msgpack")
CHIP_Q = os.path.join(REPO, "chip_inputs", "dqn_rainbow_50000_q.npz")
ATOL = 2e-2
HIDDEN = (32, 16)
B = 32
LR, TAU, GAMMA = 1e-3, 0.01, 0.99
VMAX = 10.0
CASES = {
    "dqn": dict(double_q=False),
    "double_q": dict(double_q=True),
    "dueling": dict(double_q=True, dueling=True),
    "c51": dict(double_q=True, c51=51),
    "rainbow": dict(double_q=True, dueling=True, c51=51, noisy=True, per=True, n_step=3,
                    reward_scale=0.1, grad_clip=10.0),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _record_normals(patch) -> list:
    """Wrap ``jax.random.normal`` through ``patch`` (a monkeypatch) → the
    list of the arrays it returns, in call order (flax's NoisyDense draws
    through it at call time)."""
    drawn = []
    real = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        x = real(key, shape, dtype)
        drawn.append(np.asarray(x))
        return x

    patch.setattr(jax.random, "normal", normal)
    return drawn


@pytest.fixture
def normals(monkeypatch):
    return _record_normals(monkeypatch)


def _noise_by_head(drawn, heads):
    """Recorded normals (eps_in, eps_out per head, in call order) → the
    port's ``{head: (eps_in, eps_out)}``."""
    assert len(drawn) == 2 * len(heads)
    return {h: (_t(drawn[2 * i]), _t(drawn[2 * i + 1])) for i, h in enumerate(heads)}


def _noisy_state(params) -> dict:
    p = params["params"]
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"]),
            "weight_sigma": _t(np.asarray(p["kernel_sigma"]).T), "bias_sigma": _t(p["bias_sigma"])}


def test_noisy_linear_matches_flax(normals):
    x = np.random.default_rng(0).normal(size=(8, 12)).astype(np.float32)
    jlayer = JNoisyDense(7)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_det = np.asarray(jlayer.apply(params, jnp.asarray(x)))
    y_j = np.asarray(jlayer.apply(params, jnp.asarray(x), deterministic=False,
                                  rngs={"noise": jax.random.PRNGKey(3)}))
    assert [d.shape for d in normals] == [(12,), (7,)]
    layer = NoisyLinear(12, 7)
    layer.load_state_dict(_noisy_state(params))
    with torch.no_grad():
        got = layer(_t(x), (_t(normals[0]), _t(normals[1])))
        det = layer(_t(x))
    np.testing.assert_allclose(got.numpy(), y_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(det.numpy(), y_det, rtol=1e-5, atol=1e-5)
    assert np.abs(y_j - y_det).max() > 1e-2


def test_noisy_linear_init_matches_flax_ranges():
    """mu weights and bias uniform in ±1/√in, both sigmas 0.5/√in, in the
    port as in flax."""
    layer = NoisyLinear(64, 40, generator=torch.Generator().manual_seed(0))
    jp = JNoisyDense(40).init(jax.random.PRNGKey(0), jnp.zeros((1, 64)))["params"]
    bound, sig0 = 1.0 / np.sqrt(64), np.float32(0.5 / np.sqrt(64))
    for got, want in ((layer.weight.detach(), jp["kernel"]), (layer.bias.detach(), jp["bias"])):
        assert float(got.abs().max()) <= bound and float(np.abs(want).max()) <= bound
        assert float(got.abs().max()) > 0.9 * bound and float(got.std()) > 0.5 * bound
    assert torch.all(layer.weight_sigma == sig0) and torch.all(layer.bias_sigma == sig0)
    assert np.all(np.asarray(jp["kernel_sigma"]) == sig0)
    assert np.all(np.asarray(jp["bias_sigma"]) == sig0)


HEADS = [(dueling, atoms, noisy) for dueling in (False, True) for atoms in (0, 11)
         for noisy in (False, True)]


@pytest.mark.parametrize("encoder", ["lowdim", "conv"])
@pytest.mark.parametrize("dueling,atoms,noisy", HEADS)
def test_q_network_matches_flax(dueling, atoms, noisy, encoder, normals):
    rng = np.random.default_rng(1)
    if encoder == "lowdim":
        obs = rng.normal(size=(6, 3, 2, 7)).astype(np.float32)
        kw = dict(hidden=HIDDEN)
    else:
        obs = rng.integers(0, 256, (6, 2, 3 * 25 * 25), dtype=np.uint8)
        kw = dict(hidden=HIDDEN, use_raw_pixels=True, pixel_encoder="conv", height=25, width=25)
    jq = JQNetwork(num_actions=5, dueling=dueling, num_atoms=atoms, noisy=noisy, **kw)
    params = jq.init(jax.random.PRNGKey(2), jnp.zeros(obs.shape, jnp.float32))
    want = np.asarray(jq.apply(params, jnp.asarray(obs)))
    q = QNetwork(obs.shape[1:], dueling=dueling, num_atoms=atoms, noisy=noisy, device="cpu", **kw)
    q.load_state_dict(q_network_params_from_flax(jax.device_get(params)))
    assert want.shape == ((6, 5, atoms) if atoms else (6, 5))
    with torch.no_grad():
        got = q(_t(obs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()))
    if not noisy:
        return
    del normals[:]
    want_n = np.asarray(jq.apply(params, jnp.asarray(obs), noise=True,
                                 rngs={"noise": jax.random.PRNGKey(4)}))
    noise = _noise_by_head(normals, q.head_order)
    with torch.no_grad():
        got_n = q(_t(obs), noise)
        drawn = q(_t(obs), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got_n.numpy(), want_n, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want_n).max()))
    assert np.abs(want_n - want).max() > 1e-2
    assert drawn.shape == got.shape and not torch.allclose(drawn, got)


def test_projection_matches_jax():
    rng = np.random.default_rng(3)
    z = np.linspace(0.0, 10.0, 51, dtype=np.float32)
    logits = rng.normal(size=(64, 51)).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    tz = rng.uniform(-3.0, 14.0, (64, 51)).astype(np.float32)
    want = np.asarray(jdqn._categorical_projection(jnp.asarray(p), jnp.asarray(tz), z))
    got = dqn.categorical_projection(_t(p), _t(tz), dqn.support(0.0, 10.0, 51))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(dqn.support(0.0, 10.0, 51), _t(z))


Z11 = dqn.support(0.0, 10.0, 11)  # atoms at 0, 1, ..., 10


def _identity():
    p = torch.tensor([[0.1, 0.0, 0.2, 0.0, 0.0, 0.3, 0.0, 0.0, 0.0, 0.0, 0.4]])
    return dqn.categorical_projection(p, Z11[None, :], Z11), {"all": p[0]}


def _split():
    p = torch.zeros((1, 11))
    p[0, 4] = 1.0
    tz = torch.full((1, 11), 5.0)
    tz[0, 4] = 2.25
    return dqn.categorical_projection(p, tz, Z11), {2: 0.75, 3: 0.25}


def _clip():
    p = torch.full((1, 11), 1.0 / 11.0)
    low = dqn.categorical_projection(p, torch.full((1, 11), -5.0), Z11)
    high = dqn.categorical_projection(p, torch.full((1, 11), 99.0), Z11)
    return torch.stack([low[0, 0], high[0, 10]])[None], {"all": torch.ones(2)}


def _mass():
    g = torch.Generator().manual_seed(0)
    p = torch.softmax(torch.randn((64, 11), generator=g), dim=-1)
    tz = torch.rand((64, 11), generator=g) * 17.0 - 3.0
    m = dqn.categorical_projection(p, tz, Z11)
    assert float(m.min()) >= 0.0
    return m.sum(-1)[None], {"all": torch.ones(64)}


@pytest.mark.parametrize("case", [_identity, _split, _clip, _mass],
                         ids=["identity", "neighbour_split", "clipping", "mass_preserved"])
def test_projection_properties(case):
    """tests/test_c51.py's four cases of the Bellemare et al. (2017)
    projection, on the port."""
    m, want = case()
    for atom, value in want.items():
        got = m[0] if atom == "all" else m[0, atom]
        np.testing.assert_allclose(np.asarray(got), np.asarray(value), rtol=1e-5, atol=1e-6)


def _adam_mu(opt_state):
    """The first moment of the (clip-chained) Adam state."""
    for part in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(part, "mu"):
            return part.mu
    raise AssertionError("no Adam state")


def _batch(obs_shape, hp, seed):
    rng = np.random.default_rng(seed)
    r_hi = 3.0 if hp.get("n_step", 1) > 1 else 1.0
    return (rng.normal(size=(B, *obs_shape)).astype(np.float32),
            rng.integers(0, 5, B).astype(np.int32),
            rng.uniform(0.0, r_hi, B).astype(np.float32),
            rng.normal(size=(B, *obs_shape)).astype(np.float32),
            rng.random(B) < 0.25)


def _iw(hp, seed):
    if not hp.get("per"):
        return None
    w = np.random.default_rng(seed + 100).uniform(0.1, 1.0, B).astype(np.float32)
    return w / w.max()


def _jax_update(train_once, bundle, batch, iw, key, normals, heads, hp):
    """One JAX update, unjitted, recording the NoisyNet normals it draws →
    (bundle, loss, priority, the port's noise dict)."""
    del normals[:]
    ones = jnp.ones((B,), jnp.float32)
    bundle, losses, td_abs = train_once(bundle, tuple(jnp.asarray(x) for x in batch),
                                        ones if iw is None else jnp.asarray(iw), key)
    noise = None
    if hp.get("noisy"):
        order = ("target", "select", "loss") if hp["double_q"] else ("target", "loss")
        n = 2 * len(heads)
        assert len(normals) == n * len(order)
        noise = {w: _noise_by_head(normals[i * n:(i + 1) * n], heads) for i, w in enumerate(order)}
    return bundle, float(losses["loss"]), np.asarray(td_abs), noise


def _one_update(name, normals):
    """One JAX DQN train_once (from make_segment's closure) and the same
    update in the port, from the same params, batch, weights and draws."""
    hp = CASES[name]
    jcfg = JConfig(discrete_actions=True)
    cfg = CartpoleConfig(discrete_actions=True)
    net_kw = dict(dueling=hp.get("dueling", False), num_atoms=hp.get("c51", 0),
                  noisy=hp.get("noisy", False))
    jq = JQNetwork(num_actions=5, hidden=HIDDEN, **net_kw)
    dummy = jnp.zeros((2,) + jcfg.obs_shape)
    params, target = (jq.init(jax.random.PRNGKey(k), dummy) for k in (5, 6))
    clip = hp.get("grad_clip", 0.0)
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(LR)) if clip else optax.adam(LR)
    seg_kw = dict(gamma=GAMMA, tau=TAU, reward_scale=hp.get("reward_scale", 1.0),
                  double_q=hp["double_q"], n_step=hp.get("n_step", 1),
                  c51_atoms=hp.get("c51", 0), c51_vmin=0.0, c51_vmax=VMAX,
                  noisy=hp.get("noisy", False))
    seg = jdqn.make_segment(
        jcommon.make_venv(jcfg, 4), jq, tx, batch_size=B, warmup_steps=0, steps_per_segment=1,
        eps_start=0.0, eps_end=0.0, eps_decay_steps=1,
        per_alpha=0.6 if hp.get("per") else None, **seg_kw)
    train_once = _closure(seg)["train_once"]

    q = QNetwork(cfg.obs_shape, hidden=HIDDEN, device="cpu", **net_kw)
    q.load_state_dict(q_network_params_from_flax(jax.device_get(params)))
    target_q = QNetwork(cfg.obs_shape, hidden=HIDDEN, device="cpu", **net_kw)
    target_q.load_state_dict(q_network_params_from_flax(jax.device_get(target)))
    opt, sched = ddpg.adam(q, LR)
    st = dqn.DQNState(q=q, target_q=target_q.requires_grad_(False), opt=opt, sched=sched,
                      replay=None, env_states=None, obs=None,
                      generator=torch.Generator().manual_seed(0))
    target0 = {k: v.clone() for k, v in st.target_q.state_dict().items()}
    port_once = dqn.make_train_once(grad_clip=clip, **seg_kw)

    batch, iw = _batch(cfg.obs_shape, hp, 0), _iw(hp, 0)
    bundle, loss_j, prio_j, noise = _jax_update(
        train_once, (params, target, tx.init(params)), batch, iw, jax.random.PRNGKey(7), normals,
        q.head_order, hp)
    loss, prio = port_once(st, tuple(_t(x) for x in batch), None if iw is None else _t(iw), noise)
    return SimpleNamespace(name=name, hp=hp, st=st, loss=float(loss), prio=prio.numpy(),
                           loss_j=loss_j, prio_j=prio_j, bundle=bundle, target0=target0,
                           port_once=port_once, train_once=train_once, obs_shape=cfg.obs_shape)


@pytest.fixture(scope="module")
def module_normals():
    with pytest.MonkeyPatch.context() as mp:
        yield _record_normals(mp)


@pytest.fixture(scope="module", params=list(CASES))
def update(request, module_normals):
    return _one_update(request.param, module_normals)


def test_train_once_loss_and_priorities_match_jax(update):
    assert update.loss == pytest.approx(update.loss_j, rel=2e-2)
    assert update.loss > 0.0
    scale = max(1.0, float(np.abs(update.prio_j).max()))
    np.testing.assert_allclose(update.prio, update.prio_j, rtol=0, atol=2e-2 * scale)
    assert update.prio.shape == (B,) and np.all(update.prio >= 0.0)


def test_train_once_gradients_match_jax(update):
    """The port's (clipped) gradients against JAX's, read off Adam's first
    moment after its first step."""
    mu = jax.device_get(_adam_mu(update.bundle[2]))
    want = q_network_params_from_flax(jax.tree.map(lambda m: np.asarray(m) / 0.1, mu))
    got = dict(update.st.q.named_parameters())
    assert got.keys() == want.keys()
    for k, w in want.items():
        rel = float(torch.linalg.vector_norm(got[k].grad - w) / torch.linalg.vector_norm(w))
        assert rel <= 5e-2, f"{k}: relative gradient error {rel:.3g}"


def test_train_once_params_match_jax_after_adam(update):
    want = q_network_params_from_flax(jax.device_get(update.bundle[0]))
    flipped = total = 0
    for k, v in update.st.q.state_dict().items():
        gap = (v - want[k]).abs()
        assert float(gap.max()) <= 2 * LR + 1e-6, f"{k}: {float(gap.max()):.3g} beyond 2·lr"
        flipped += int((gap > LR).sum())
        total += gap.numel()
    assert flipped / total <= 1e-4


def test_train_once_target_moves_by_tau(update):
    """target ← target + τ·(online − target) over the port's updated online
    net (the sigmas too), and within τ·2·lr of JAX's target."""
    want_jax = q_network_params_from_flax(jax.device_get(update.bundle[1]))
    online = update.st.q.state_dict()
    for k, v in update.st.target_q.state_dict().items():
        step = update.target0[k] + TAU * (online[k] - update.target0[k])
        np.testing.assert_allclose(v.numpy(), step.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), want_jax[k].numpy(), rtol=0,
                                   atol=TAU * 2 * LR + 1e-6)
        assert not torch.equal(v, update.target0[k])


def test_rainbow_params_match_jax_after_two_updates(module_normals):
    u = _one_update("rainbow", module_normals)
    batch, iw = _batch(u.obs_shape, u.hp, 1), _iw(u.hp, 1)
    bundle, loss_j, _, noise = _jax_update(u.train_once, u.bundle, batch, iw,
                                           jax.random.PRNGKey(8), module_normals,
                                           u.st.q.head_order, u.hp)
    loss, _ = u.port_once(u.st, tuple(_t(x) for x in batch), _t(iw), noise)
    assert float(loss) == pytest.approx(loss_j, rel=2e-2)
    want = q_network_params_from_flax(jax.device_get(bundle[0]))
    gap = max(float((v - want[k]).abs().max()) / LR for k, v in u.st.q.state_dict().items())
    print(f"rainbow: largest gap after two updates, in lr: {gap:.3g}")
    assert gap <= 1.0


RAINBOW = dict(double_q=True, c51_atoms=51, c51_vmax=VMAX, noisy=True, reward_scale=0.1,
               grad_clip=10.0)


def _segment_state(per: bool, **net):
    cfg = CartpoleConfig(discrete_actions=True, max_episode_len=5)
    venv = make_venv(cfg, 8, device="cpu")
    opts = SimpleNamespace(seed=0, replay_capacity=64, per=per, **net)
    return venv, dqn.init_state(opts, cfg, venv, hidden=HIDDEN)


def test_segment_eps_reads_env_steps_before_the_increment():
    """ε = 1 → 0 over 2 steps, every uniform 0.75, every random action 4:
    step 0 explores (ε 1, the pre-increment count 0), steps 1-2 act greedy
    (ε 0.5 and 0); the gate opens at warmup + 1 = 2.  Actions in [0, 5)."""
    venv, st = _segment_state(False)
    seg = dqn.make_segment(venv, gamma=GAMMA, tau=TAU, batch_size=8, warmup_steps=1,
                           steps_per_segment=3, eps_start=1.0, eps_end=0.0, eps_decay_steps=2)
    draws = [{"explore_u": torch.full((8,), 0.75), "random_action": torch.full((8,), 4)}] * 3
    untrained = copy.deepcopy(st.q)
    m = seg(st, draws)
    actions = st.replay.action[:24].reshape(3, 8)
    assert st.replay.action.dtype == torch.int32
    assert torch.all(actions[0] == 4)
    # Step 1 acts before the first update, greedy (0.75 ≥ ε 0.5).
    assert torch.equal(actions[1], dqn.greedy_act(untrained)(st.replay.s1[8:16]).to(torch.int32))
    assert bool(((actions >= 0) & (actions < 5)).all())
    assert m["eps"] == pytest.approx((1.0 + 0.5 + 0.0) / 3)
    assert m["updates"] == 2 and st.env_steps == 3
    assert set(m) == {"loss", "reward", "eps", "done_frac", "double_reset_frac", "updates"}
    assert float(m["loss"]) > 0.0


def test_segment_per_anneals_beta_and_writes_back_only_trained_steps(monkeypatch):
    """The Rainbow segment: β from per_beta0 toward 1 by the post-increment
    step count, one priority write-back per update and none before the gate
    opens (n-step 3 needs 4 blocks: the first update at step 4)."""
    venv, st = _segment_state(True, dueling=True, c51=51, noisy=True)
    betas, writes = [], []
    real_sample, real_update = dqn.replay_mod.sample_prioritized, dqn.replay_mod.update_priorities

    def sample(replay, batch_size, alpha, beta, **kw):
        betas.append(beta)
        return real_sample(replay, batch_size, alpha, beta, **kw)

    def update(replay, idx, priority, eps=1e-2, gate=None):
        writes.append((idx.clone(), priority.clone()))
        return real_update(replay, idx, priority, eps, gate)

    monkeypatch.setattr(dqn.replay_mod, "sample_prioritized", sample)
    monkeypatch.setattr(dqn.replay_mod, "update_priorities", update)
    seg = dqn.make_segment(venv, batch_size=8, warmup_steps=1, steps_per_segment=6,
                           eps_start=0.0, eps_end=0.0, eps_decay_steps=1, gamma=GAMMA, tau=TAU,
                           per_alpha=0.6, per_beta0=0.4, per_total_steps=12, n_step=3, **RAINBOW)
    before = st.replay.priority.clone()
    m = seg(st)
    assert m["updates"] == 3 and len(writes) == 3
    assert betas == pytest.approx([0.4 + 0.6 * s / 12 for s in (4, 5, 6)])
    for idx, priority in writes:
        assert priority.shape == (8,) and bool((priority > 0).all())
    idx, priority = writes[-1]
    np.testing.assert_allclose(st.replay.priority[idx].numpy(), (priority + 1e-2).numpy(),
                               rtol=1e-6)
    assert torch.equal(before, torch.ones(64))
    assert m["eps"] == 0.0 and np.isfinite(float(m["loss"]))


@pytest.fixture(scope="module")
def checkpoint():
    with open(CKPT, "rb") as f:
        jraw = serialization.msgpack_restore(f.read())
    return jraw, dqn_params_from_jax_checkpoint(CKPT)


def test_checkpoint_greedy_actions_match_flax(checkpoint):
    """The full Rainbow checkpoint (dueling, C51 51, noisy), read without
    flax, against flax on its own 128 carried observations: the greedy
    actions equal, the C51 means on the unit support within 2e-2."""
    jraw, port = checkpoint
    jq = JQNetwork(num_actions=5, dueling=True, num_atoms=51, noisy=True)
    obs = np.asarray(jraw["obs"])
    assert obs.shape == (128, 3, 2, 7) and torch.equal(port["obs"], _t(obs))
    a_j = np.asarray(jdqn.greedy_act(jq)(jraw["params"], jnp.asarray(obs)))
    out_j = np.asarray(jq.apply(jraw["params"], jnp.asarray(obs)))
    z = np.linspace(0.0, 1.0, 51, dtype=np.float32)
    mean_j = (np.exp(out_j - out_j.max(-1, keepdims=True))
              / np.exp(out_j - out_j.max(-1, keepdims=True)).sum(-1, keepdims=True) * z).sum(-1)
    q = QNetwork((3, 2, 7), dueling=True, num_atoms=51, noisy=True, device="cpu")
    q.load_state_dict(port["params"])
    QNetwork((3, 2, 7), dueling=True, num_atoms=51, noisy=True,
             device="cpu").load_state_dict(port["target_params"])
    a = dqn.greedy_act(q)(port["obs"])
    with torch.no_grad():
        mean = dqn.q_scalar(q(port["obs"]), dqn.support(0.0, 1.0, 51))
    np.testing.assert_array_equal(a.numpy(), a_j)
    np.testing.assert_allclose(mean.numpy(), mean_j, rtol=0, atol=ATOL)
    assert len(set(a_j.tolist())) > 1
    assert port["env_steps"] == int(np.asarray(jraw["env_steps"]))


def test_chip_q_npz_equals_checkpoint(checkpoint):
    """chip_inputs' npz holds the checkpoint's online leaves, leaf for leaf
    and byte for byte, and maps to the same state_dict."""
    jraw, port = checkpoint
    want = flatten_tree(jax.tree.map(np.asarray, jraw["params"]))
    with np.load(CHIP_Q) as f:
        got = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    sd = q_network_params_from_flax(unflatten_tree(got))
    assert sd.keys() == port["params"].keys()
    assert all(torch.equal(sd[k], port["params"][k]) for k in sd)

"""The port's NAF network and learner against the JAX package on the CPU:
``lower_triangular``, ``advantage`` and ``q_value`` (clamped diagonals
too), the ``NAFNetwork`` forward on flax weights with and without batch
norm in train and eval mode (low-dim, dense and conv pixel encoders), one
and two ``train_once`` updates against the JAX ``make_segment``'s own
``train_once`` fed the same batches, and the training segment's
bookkeeping and draws (torch only).

Tolerances and why:
- the NAF algebra at atol 1e-6 (float32, the same operations).
- forward outputs within 2e-2 of their scale, the bf16 bound of
  tests/test_torch_slice.py: the encoder computes in bfloat16 and the two
  frameworks round at different places.  Low-dim batch statistics at rtol
  1e-5 (the raw observations, no bf16 on their way); the conv encoder's
  within 2e-2 of the features' scale (bf16 features).
- one update: the loss at rtol 2e-2, params within 2·lr
  (tests/test_torch_ddpg.py's bounds and reasons: Adam's first step moves
  each parameter by lr·g/(|g| + ε), so a gradient entry that bf16
  rounding flips in sign moves it 2·lr the other way).  The step is also
  held by direction: an entry more than lr from JAX's (moved the opposite
  way) must have a JAX gradient under 2e-2 of its tensor's median |g|,
  i.e. one that rounding can flip.  Measured on the CPU: none in the
  low-dim cases; with the conv encoder and batch norm 15 of 33270 conv
  weights, their |g| 2e-5 to 1.6e-2 of the median.  Two updates within
  1·lr on the low-dim path (its reasons in the test); the statistics as
  the forward's.
- targets: the Polyak step over the port's own online network at atol
  1e-6, and JAX's targets within τ·2·lr + 1e-6.
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
from cartpoleplusplus_tpu.agents import naf as jnaf
from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.models import NAFNetwork as JNAF
from cartpoleplusplus_tpu_torch.agents import naf
from cartpoleplusplus_tpu_torch.agents.common import make_venv
from cartpoleplusplus_tpu_torch.agents.ddpg import adam
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.models.networks import NAFNetwork
from cartpoleplusplus_tpu_torch.utils.params import naf_network_params_from_flax

torch.set_num_threads(2)

HIDDEN = (32, 16)
LOWDIM = dict(discrete_actions=False)
# The 1-camera exact row's frames (3 repeats × 3 × 25 × 25).
PIXELS = dict(discrete_actions=False, use_raw_pixels=True, num_cameras=1, obs_pool=2,
              obs_samples=0)
ENCODERS = {"lowdim": (LOWDIM, "dense"), "dense": (PIXELS, "dense"), "conv": (PIXELS, "conv")}
B = 16
LR, TAU, GAMMA = 1e-3, 0.005, 0.99


def _t(x):
    return torch.from_numpy(np.array(x))


def test_lower_triangular_advantage_and_q_match_jax():
    """Entries in [−8, 4], so diagonals fall below, inside and above the
    clamp [−5, 2]; actions away from µ and at µ."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 3):
        k = n * (n + 1) // 2
        l_flat = rng.uniform(-8.0, 4.0, (64, k)).astype(np.float32)
        mu = rng.uniform(-1, 1, (64, n)).astype(np.float32)
        a = rng.uniform(-1, 1, (64, n)).astype(np.float32)
        v = rng.normal(size=64).astype(np.float32)
        want_l = np.asarray(JNAF.lower_triangular(jnp.asarray(l_flat), n))
        got_l = NAFNetwork.lower_triangular(_t(l_flat), n).numpy()
        np.testing.assert_allclose(got_l, want_l, rtol=0, atol=1e-6)
        diag = np.diagonal(want_l, axis1=-2, axis2=-1)
        assert diag.min() == pytest.approx(np.exp(-5.0)) and diag.max() == pytest.approx(np.exp(2))
        assert np.all(np.triu(got_l, 1) == 0.0)
        np.testing.assert_allclose(
            NAFNetwork.advantage(_t(l_flat), _t(mu), _t(a)).numpy(),
            np.asarray(JNAF.advantage(jnp.asarray(l_flat), jnp.asarray(mu), jnp.asarray(a))),
            rtol=0, atol=1e-6 * max(1.0, float(np.abs(want_l).max()) ** 2))
        np.testing.assert_allclose(
            NAFNetwork.q_value(_t(v), _t(l_flat), _t(mu), _t(a)).numpy(),
            np.asarray(JNAF.q_value(jnp.asarray(v), jnp.asarray(l_flat), jnp.asarray(mu),
                                    jnp.asarray(a))),
            rtol=0, atol=1e-6 * max(1.0, float(np.abs(want_l).max()) ** 2))
        assert np.all(NAFNetwork.advantage(_t(l_flat), _t(mu), _t(mu)).numpy() == 0.0)


def test_advantage_gradient_matches_jax():
    """The gradient through the clamp and the exponentiated diagonal."""
    rng = np.random.default_rng(1)
    l_flat = rng.uniform(-6.0, 3.0, (32, 3)).astype(np.float32)
    mu = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    a = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    want = jax.grad(lambda lf, m: jnp.sum(JNAF.advantage(lf, m, jnp.asarray(a))),
                    argnums=(0, 1))(jnp.asarray(l_flat), jnp.asarray(mu))
    lt, mt = _t(l_flat).requires_grad_(True), _t(mu).requires_grad_(True)
    NAFNetwork.advantage(lt, mt, _t(a)).sum().backward()
    for got, w in zip((lt.grad, mt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    clamped = (l_flat[:, [0, 2]] < -5.0) | (l_flat[:, [0, 2]] > 2.0)
    assert clamped.any() and np.all(lt.grad.numpy()[:, [0, 2]][clamped] == 0.0)


def _jnet(cfg_kw, encoder, bn):
    cfg = JConfig(**cfg_kw)
    kw = dict(use_raw_pixels=True, pixel_encoder=encoder, height=cfg.obs_height,
              width=cfg.obs_width) if cfg.use_raw_pixels else {}
    return cfg, JNAF(action_dim=2, hidden=HIDDEN, use_batch_norm=bn, **kw)


def _port_net(cfg_kw, encoder, bn):
    cfg = CartpoleConfig(**cfg_kw)
    kw = dict(use_raw_pixels=True, pixel_encoder=encoder, height=cfg.obs_height,
              width=cfg.obs_width) if cfg.use_raw_pixels else {}
    return NAFNetwork(cfg.obs_shape, hidden=HIDDEN, use_batch_norm=bn, device="cpu", **kw)


def _obs(cfg, rng, b=B):
    if cfg.use_raw_pixels:
        return rng.integers(0, 256, (b, *cfg.obs_shape), dtype=np.uint8)
    means = rng.uniform(-2.0, 2.0, cfg.obs_shape)
    return (means + rng.uniform(0.3, 1.5, cfg.obs_shape) * rng.normal(
        size=(b, *cfg.obs_shape))).astype(np.float32)


def _init(jnet, cfg, rng, key=0):
    """flax variables with heads drawn at the hidden layers' scale (the
    final-layer init's ±3e-3 would hide a wrong head) and, with batch
    norm, scale, bias and running statistics away from their init."""
    variables = jax.device_get(dict(jnet.init(jax.random.PRNGKey(key),
                                              jnp.zeros((2, *cfg.obs_shape), jnp.float32))))
    params = jax.tree.map(np.array, variables["params"])
    for head in ("value", "mu", "l_entries"):
        k = params[head]["kernel"]
        params[head]["kernel"] = (rng.normal(size=k.shape) / np.sqrt(k.shape[0])).astype(
            np.float32)
    out = {"params": params}
    if "batch_stats" in variables:
        bn = params["ObsEncoder_0"]["BatchNorm_0"]
        f = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
        bn["bias"] = (0.1 * rng.normal(size=f)).astype(np.float32)
        out["batch_stats"] = {"ObsEncoder_0": {"BatchNorm_0": {
            "mean": (0.2 * rng.normal(size=f)).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, f).astype(np.float32)}}}
    return out


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_naf_network_matches_flax(encoder, bn, train):
    cfg_kw, enc = ENCODERS[encoder]
    rng = np.random.default_rng(2)
    jcfg, jnet = _jnet(cfg_kw, enc, bn)
    variables = _init(jnet, jcfg, rng)
    obs = _obs(jcfg, rng, 32)
    if train and bn:
        want, new = jnet.apply(variables, jnp.asarray(obs), True, mutable=["batch_stats"])
    else:
        want, new = jnet.apply(variables, jnp.asarray(obs), train), None
    net = _port_net(cfg_kw, enc, bn)
    net.load_state_dict(naf_network_params_from_flax(variables))
    with torch.no_grad():
        got = net(_t(obs), train=train)
    assert [tuple(g.shape) for g in got] == [(32,), (32, 2), (32, 3)]
    for g, w, name in zip(got, want, ("value", "mu", "l_entries")):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.05, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-2 * np.abs(w).max(),
                                   err_msg=name)
    if bn:
        stats = variables["batch_stats"] if new is None else new["batch_stats"]
        for k in ("mean", "var"):
            w = np.asarray(stats["ObsEncoder_0"]["BatchNorm_0"][k])
            g = getattr(net.encoder.batch_norm, k).numpy()
            if encoder == "lowdim" or new is None:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * np.abs(w).max())
            if train:
                assert not np.array_equal(
                    g, variables["batch_stats"]["ObsEncoder_0"]["BatchNorm_0"][k])


def test_train_flag_matters_only_with_batch_norm():
    """Without batch norm train and eval mode give the same numbers; with
    it they differ and only train mode moves the statistics."""
    rng = np.random.default_rng(3)
    cfg = CartpoleConfig(**LOWDIM)
    obs = _t(_obs(cfg, rng))
    for bn in (False, True):
        net = _port_net(LOWDIM, "dense", bn)
        before = copy.deepcopy(net.state_dict())
        with torch.no_grad():
            ev = net(obs)
            after_eval = copy.deepcopy(net.state_dict())
            tr = net(obs, train=True)
        same = all(torch.equal(a, b) for a, b in zip(ev, tr))
        assert same != bn
        assert all(torch.equal(after_eval[k], v) for k, v in before.items())
        moved = [k for k, v in net.state_dict().items() if not torch.equal(v, before[k])]
        assert moved == (["encoder.batch_norm.mean", "encoder.batch_norm.var"] if bn else [])


# --- train_once against JAX's --------------------------------------------------

CASES = {
    "lowdim": (LOWDIM, "dense", False, dict(reward_scale=0.1)),
    "lowdim_bn": (LOWDIM, "dense", True, dict(reward_scale=0.1, grad_clip=1.0)),
    "conv_bn": (PIXELS, "conv", True, dict()),
}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return (_obs(cfg, rng), rng.uniform(-1, 1, (B, 2)).astype(np.float32),
            rng.normal(size=B).astype(np.float32), _obs(cfg, rng), rng.random(B) < 0.25)


@functools.cache
def _updates(name):
    """Two JAX train_once calls (from make_segment's closure) and the same
    two updates in the port, from the same variables and batches."""
    cfg_kw, enc, bn, hp = CASES[name]
    jcfg, jnet = _jnet(cfg_kw, enc, bn)
    rng = np.random.default_rng(4)
    variables = _init(jnet, jcfg, rng)
    if bn:  # train from flax's init statistics, as a run does
        variables["batch_stats"] = jax.device_get(
            jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, *jcfg.obs_shape)))["batch_stats"])
    clip = hp.get("grad_clip", 0.0)
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(LR)) if clip else optax.adam(LR)
    seg = jnaf.make_segment(
        jcommon.make_venv(jcfg, 4), jnet, tx, gamma=GAMMA, tau=TAU, batch_size=B,
        warmup_steps=0, steps_per_segment=1, ou_theta=0.15, ou_sigma=0.2,
        reward_scale=hp.get("reward_scale", 1.0))
    train_once = jax.jit(dict(zip(seg.__code__.co_freevars,
                                  (c.cell_contents for c in seg.__closure__)))["train_once"])
    bundles, jlosses = [(variables, variables, tx.init(variables["params"]))], []

    cfg = CartpoleConfig(**cfg_kw)
    net = _port_net(cfg_kw, enc, bn)
    net.load_state_dict(naf_network_params_from_flax(variables))
    opt, sched = adam(net, LR)
    st = naf.NAFState(net=net, target_net=copy.deepcopy(net).requires_grad_(False), opt=opt,
                      sched=sched, replay=None, env_states=None, obs=None, ou_noise=None,
                      generator=torch.Generator().manual_seed(0))
    port_once = naf.make_train_once(gamma=GAMMA, tau=TAU, **hp)
    losses, states = [], [(copy.deepcopy(net.state_dict()),
                           copy.deepcopy(st.target_net.state_dict()))]
    for step in (1, 2):
        batch = _batch(cfg, seed=10 + step)
        new, jl = train_once(bundles[-1], tuple(jnp.asarray(x) for x in batch))
        bundles.append(jax.device_get(new))
        jlosses.append(float(jl["loss"]))
        losses.append(float(port_once(st, tuple(_t(x) for x in batch))))
        states.append((copy.deepcopy(net.state_dict()),
                       copy.deepcopy(st.target_net.state_dict())))
    return SimpleNamespace(name=name, bn=bn, enc=enc, cfg_kw=cfg_kw, bundles=bundles,
                           jlosses=jlosses, losses=losses, states=states)


@pytest.fixture(scope="module", params=list(CASES))
def updates(request):
    return _updates(request.param)


def _is_stat(k):
    return k.endswith("batch_norm.mean") or k.endswith("batch_norm.var")


def _check_stats(u, got, want):
    for k in filter(_is_stat, got):
        if u.cfg_kw is LOWDIM:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                       atol=2e-2 * float(want[k].abs().max()), err_msg=k)


def test_train_once_losses_match_jax(updates):
    for got, want in zip(updates.losses, updates.jlosses):
        assert got == pytest.approx(want, rel=2e-2)
        assert got > 0.0


def _jax_grads(opt_state):
    """JAX's gradient of the first update, read off Adam's first moment
    (``mu = 0.1·g`` after one step; after the clip, if any)."""
    def find(state):
        if hasattr(state, "mu"):
            return state
        if isinstance(state, tuple):
            return next((f for f in map(find, state) if f is not None), None)
        return None

    return {k: 10.0 * v for k, v in naf_network_params_from_flax(
        {"params": jax.device_get(find(opt_state).mu)}).items()}


def test_train_once_params_match_jax_after_one_update(updates):
    u = updates
    want = naf_network_params_from_flax(u.bundles[1][0])
    grads = _jax_grads(u.bundles[1][2])
    got, before = u.states[1][0], u.states[0][0]
    assert got.keys() == want.keys()
    flipped = total = 0
    for k, v in got.items():
        if _is_stat(k):
            continue
        gap = (v - want[k]).abs()
        assert float(gap.max()) <= 2 * LR + 1e-6, f"{k}: {float(gap.max()):.3g} beyond 2·lr"
        assert not torch.equal(v, before[k]), f"{k} did not move"
        g = grads[k].abs()
        opposite = gap > LR
        assert bool((g[opposite] <= 2e-2 * g.median()).all()), (
            f"{k}: an entry with a gradient above rounding moved opposite to JAX's")
        flipped += int(opposite.sum())
        total += gap.numel()
    print(f"{u.name}: {flipped} of {total} entries moved opposite to JAX's")
    _check_stats(u, got, want)
    assert sum(map(_is_stat, got)) == (2 if u.bn else 0)


@pytest.mark.parametrize("name", ["lowdim", "lowdim_bn"])
def test_train_once_params_match_jax_after_two_updates(name):
    """After two Adam steps no per-step saturation bounds the gap; the bound
    is 1·lr, as for DDPG (tests/test_torch_ddpg.py), with and without
    batch norm on the low-dim path, which the learning runs take.  The conv
    encoder with batch norm is held by one update: there Adam's sign-like
    steps on its rounding-level gradients (the one-update test's flipped
    entries) carry into the second step, 1.67·lr off on the CPU."""
    u = _updates(name)
    want = naf_network_params_from_flax(u.bundles[2][0])
    got = u.states[2][0]
    gaps = {k: float((v - want[k]).abs().max()) / LR for k, v in got.items() if not _is_stat(k)}
    worst = max(gaps, key=gaps.get)
    print(f"{u.name}: largest gap after two updates {gaps[worst]:.3f}·lr at {worst}")
    assert gaps[worst] <= 1.0, (worst, gaps[worst])
    _check_stats(u, got, want)


def test_train_once_target_is_the_polyak_step(updates):
    """Every target parameter and statistic moves by τ toward the online
    network's (the port's own, at atol 1e-6), and lies within τ·2·lr of
    JAX's target (its statistics as the online ones)."""
    u = updates
    (online, target), (_, target0) = u.states[1], u.states[0]
    want_jax = naf_network_params_from_flax(u.bundles[1][1])
    for k, v in target.items():
        step = (1.0 - TAU) * target0[k] + TAU * online[k]
        np.testing.assert_allclose(v.numpy(), step.numpy(), rtol=0, atol=1e-6, err_msg=k)
        if not _is_stat(k):
            np.testing.assert_allclose(v.numpy(), want_jax[k].numpy(), rtol=0,
                                       atol=TAU * 2 * LR + 1e-6, err_msg=k)
    _check_stats(u, target, want_jax)


# --- the segment (torch only) ----------------------------------------------------

@pytest.fixture(scope="module")
def segment_run():
    """Segments of the plain versions on 16 low-dim envs: warmup 2, replay
    of 4 blocks (min fill 48 transitions), episodes capped at 3 steps,
    batch norm on."""
    cfg = CartpoleConfig(max_episode_len=3, **LOWDIM)
    venv = make_venv(cfg, 16, device="cpu")
    st = naf.init_state(SimpleNamespace(seed=0, replay_capacity=64, use_batch_norm=True), cfg,
                        venv, hidden=HIDDEN)
    hp = dict(gamma=GAMMA, tau=TAU, batch_size=8, warmup_steps=2, ou_theta=0.15, ou_sigma=0.2)
    net0 = copy.deepcopy(st.net.state_dict())
    first = naf.make_segment(venv, steps_per_segment=2, **hp)(st)
    after_first = dict(size=st.replay.size, steps=st.env_steps,
                       same=all(torch.equal(v, net0[k]) for k, v in st.net.state_dict().items()))
    second = naf.make_segment(venv, steps_per_segment=1, **hp)(st)
    after_second = dict(size=st.replay.size, steps=st.env_steps, ou=st.ou_noise.clone())
    return SimpleNamespace(venv=venv, st=st, hp=hp, first=first, second=second,
                           after_first=after_first, after_second=after_second)


def test_segment_gate_and_bookkeeping(segment_run):
    r = segment_run
    assert r.first["updates"] == 0 and r.after_first["same"]
    assert float(r.first["loss"]) == 0.0
    assert (r.after_first["size"], r.after_first["steps"]) == (32, 2)
    # Step 3 = warmup + 1 with 48 transitions: the first update; every
    # episode ends there (the length cap), so the OU noise is zero.
    assert r.second["updates"] == 1 and float(r.second["loss"]) > 0.0
    assert (r.after_second["size"], r.after_second["steps"]) == (48, 3)
    assert torch.equal(r.after_second["ou"], torch.zeros_like(r.after_second["ou"]))
    assert float(r.second["done_frac"]) == 1.0
    assert float(r.st.net.encoder.batch_norm.mean.abs().max()) > 0.0


def test_segment_takes_its_draws_as_arguments(segment_run):
    """The same state and the same given draws (reset pool, OU normals,
    sample offsets) give the same segment whatever the generator holds;
    the OU step and the sampled rows are the given ones."""
    r = segment_run
    e = r.venv.num_envs
    rng = np.random.default_rng(5)
    draws = {"pool": (_t(rng.uniform(0.0, 2 * np.pi, e).astype(np.float32)),
                      _t(rng.normal(size=(e, 2)).astype(np.float32))),
             "steps": [{"ou_eps": _t(rng.normal(size=(e, 2)).astype(np.float32)),
                        "offsets": _t(rng.integers(0, 16, 8))} for _ in range(2)]}
    outs = []
    for seed in (1, 2):
        st = copy.deepcopy(r.st)
        st.generator = torch.Generator().manual_seed(seed)
        metrics = naf.make_segment(r.venv, steps_per_segment=2, **r.hp)(st, draws)
        outs.append((st, metrics))
    (a, ma), (b, mb) = outs
    assert ma["updates"] == mb["updates"] == 2
    assert float(ma["loss"]) == float(mb["loss"]) > 0.0
    for k, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[k]), k
    assert torch.equal(a.replay.s1, b.replay.s1) and torch.equal(a.obs, b.obs)

"""The port's batch norm against flax's on the CPU: the layer alone (train
and eval mode, its gradient through the batch statistics), the running
statistics of a low-dim encoder over several train-mode updates and their
Polyak-averaged target, and DDPG with ``--use-batch-norm`` (one critic and
TD3's twins): one and two updates against the JAX ``make_segment``'s own
``train_once``, with each forward in the JAX update's mode, and
``ddpg_params_from_jax_checkpoint`` on a checkpoint the JAX DDPG CLI writes
with ``--use-batch-norm --twin-critic`` (the statistics copied exactly, the
twins' split from their stacked axis).

Tolerances and why:
- the layer alone: outputs and statistics at rtol 1e-5 (float32, one
  reduction order against another); gradients at rtol 1e-4 (the backward
  sums over the batch twice more).
- running statistics after 10 updates of batch 64, and the target's after
  10 Polyak steps: rtol 1e-5.  On the low-dim path the features are the
  raw observations, so the statistics do not depend on the weights and
  the bound can be this tight: an unbiased variance (torch's
  ``BatchNorm1d``) is off by about 1.5e-3 here, which the test shows.
- DDPG: losses rtol 2e-2, params after one Adam step within 2·lr, after
  two within 1·lr (tests/test_torch_ddpg.py's bounds and reasons: the
  trunk computes in bfloat16); the statistics of the online networks at
  rtol 1e-5, the critic's moved once per update (its loss), not again by
  the actor's loss, where it runs in eval mode.
"""

import copy
import shlex
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import ddpg as jddpg
from cartpoleplusplus_tpu.env import CartpoleConfig as JConfig
from cartpoleplusplus_tpu.models import Actor as JActor
from cartpoleplusplus_tpu.models import Critic as JCritic
from cartpoleplusplus_tpu.models import soft_target_update as jsoft_target_update
from cartpoleplusplus_tpu.models.trunks import ObsEncoder as JObsEncoder
from cartpoleplusplus_tpu_torch.agents import ddpg
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.models.networks import Actor, Critic, TwinCritic
from cartpoleplusplus_tpu_torch.models.target import soft_target_update
from cartpoleplusplus_tpu_torch.models.trunks import BatchNorm, ObsEncoder
from cartpoleplusplus_tpu_torch.utils.params import (
    actor_params_from_flax,
    critic_params_from_flax,
    ddpg_params_from_jax_checkpoint,
)

torch.set_num_threads(2)

HIDDEN = (32, 16)
LOWDIM = dict(discrete_actions=False)
STATS_RTOL = 1e-5


def _features(rng, b, f):
    """Features of unit-order spread around nonzero means, as low-dim
    observations are (positions and quaternion components)."""
    means = rng.uniform(-2.0, 2.0, f)
    scales = rng.uniform(0.3, 1.5, f)
    return (means + scales * rng.normal(size=(b, f))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_layer_matches_flax(train):
    """Forward, gradients (input, scale, bias, through the batch statistics
    in train mode) and the moved statistics against ``nn.BatchNorm(
    use_running_average=not train, dtype=float32)``."""
    rng = np.random.default_rng(0)
    x = _features(rng, 64, 12)
    mod = fnn.BatchNorm(use_running_average=not train, dtype=jnp.float32)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 12).astype(np.float32)),
              "bias": jnp.asarray(rng.normal(size=12).astype(np.float32))}
    stats = {"mean": jnp.asarray(rng.normal(size=12).astype(np.float32)),
             "var": jnp.asarray(rng.uniform(0.5, 2.0, 12).astype(np.float32))}
    w = rng.normal(size=(64, 12)).astype(np.float32)
    assert set(variables) == {"params", "batch_stats"}

    def loss(p, xx):
        out = mod.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        y, new = out
        return jnp.sum(y * w), (y, new["batch_stats"])

    (_, (want_y, want_stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    bn = BatchNorm(12)
    with torch.no_grad():
        bn.weight.copy_(_t(params["scale"]))
        bn.bias.copy_(_t(params["bias"]))
        bn.mean.copy_(_t(stats["mean"]))
        bn.var.copy_(_t(stats["var"]))
    xt = _t(x).requires_grad_(True)
    y = bn(xt, train)
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-4)
    for k in ("mean", "var"):
        got = getattr(bn, k)
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want_stats[k]), rtol=STATS_RTOL,
                                   atol=1e-7)
        if not train:
            assert torch.equal(got, _t(stats[k]))
    assert [k for k, _ in bn.named_buffers()] == ["mean", "var"]


def test_batch_norm_clips_a_negative_variance_at_zero():
    """A constant feature's ``E[x²] − E[x]²`` can round below 0; it is
    clipped, so the output stays finite (flax's ``_compute_stats``)."""
    x = torch.full((64, 3), 0.1, dtype=torch.float32)
    bn = BatchNorm(3)
    y = bn(x, train=True)
    assert bool(torch.isfinite(y).all())
    assert float(bn.var.min()) >= 0.99


@pytest.fixture(scope="module")
def running_stats():
    """10 train-mode forwards of a low-dim encoder with batch norm (batch
    64), each followed by a Polyak step of its target, in flax and in the
    port from the same weights."""
    cfg = CartpoleConfig(**LOWDIM)
    f = int(np.prod(cfg.obs_shape))
    rng = np.random.default_rng(1)
    batches = [_features(rng, 64, f).reshape(64, *cfg.obs_shape) for _ in range(10)]
    jenc = JObsEncoder(False, HIDDEN, use_batch_norm=True)
    variables = jax.device_get(dict(jenc.init(jax.random.PRNGKey(2), jnp.asarray(batches[0]))))
    target = variables
    tau = 0.1

    @jax.jit
    def step(variables, target, obs):
        _, new = jenc.apply(variables, obs, True, mutable=["batch_stats"])
        variables = {**variables, **new}
        return variables, jsoft_target_update(target, variables, tau)

    enc = ObsEncoder(f, hidden=HIDDEN, use_batch_norm=True)
    params = variables["params"]
    sd = {"batch_norm.weight": _t(params["BatchNorm_0"]["scale"]),
          "batch_norm.bias": _t(params["BatchNorm_0"]["bias"]),
          "batch_norm.mean": _t(variables["batch_stats"]["BatchNorm_0"]["mean"]),
          "batch_norm.var": _t(variables["batch_stats"]["BatchNorm_0"]["var"])}
    for i in range(len(HIDDEN)):
        layer = params["MLPTrunk_0"][f"hidden{i}"]
        sd[f"trunk.hidden.{i}.weight"] = _t(np.asarray(layer["kernel"]).T)
        sd[f"trunk.hidden.{i}.bias"] = _t(layer["bias"])
    enc.load_state_dict(sd)
    tenc = copy.deepcopy(enc)
    ref = torch.nn.BatchNorm1d(f, momentum=0.01)  # for the sensitivity check
    for obs in batches:
        variables, target = step(variables, target, jnp.asarray(obs))
        with torch.no_grad():
            enc(_t(obs), train=True)
            soft_target_update(tenc, enc, tau)
            ref(_t(obs).reshape(64, -1))
    return SimpleNamespace(jstats=jax.device_get(variables["batch_stats"]["BatchNorm_0"]),
                           jtarget=jax.device_get(target["batch_stats"]["BatchNorm_0"]),
                           enc=enc, tenc=tenc, ref=ref)


def test_running_stats_match_flax_over_updates(running_stats):
    r = running_stats
    for k in ("mean", "var"):
        got = getattr(r.enc.batch_norm, k).numpy()
        np.testing.assert_allclose(got, r.jstats[k], rtol=STATS_RTOL, atol=1e-7)
    # The stats moved away from their init (0, 1): 10 updates weigh the
    # batches' stats by 1 − 0.99¹⁰ ≈ 0.096.
    assert float(np.abs(r.jstats["mean"]).max()) > 0.05


def test_target_stats_follow_the_polyak_steps(running_stats):
    r = running_stats
    for k in ("mean", "var"):
        got = getattr(r.tenc.batch_norm, k).numpy()
        np.testing.assert_allclose(got, r.jtarget[k], rtol=STATS_RTOL, atol=1e-7)
        assert not np.allclose(got, getattr(r.enc.batch_norm, k).numpy())


def test_torch_batch_norm_1d_would_fail_this_bound(running_stats):
    """``nn.BatchNorm1d(momentum=0.01)`` on the same batches: its running
    variance is the unbiased one, off by more than the bound, so the test
    above can tell the two apart."""
    r = running_stats
    np.testing.assert_allclose(r.ref.running_mean.numpy(), r.jstats["mean"], rtol=STATS_RTOL,
                               atol=1e-6)
    rel = np.abs(r.ref.running_var.numpy() / r.jstats["var"] - 1.0).max()
    assert rel > 100 * STATS_RTOL, rel


# --- DDPG with --use-batch-norm -------------------------------------------------

B = 32
LR_A, LR_C = 1e-4, 1e-3
TAU, GAMMA = 0.005, 0.99
DDPG_CASES = {
    "ddpg": dict(reward_scale=0.1),
    "td3": dict(twin_critic=True, target_noise=0.2, target_noise_clip=0.5, reward_scale=0.1,
                grad_clip=1.0),
}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    f = int(np.prod(cfg.obs_shape))
    return (_features(rng, B, f).reshape(B, *cfg.obs_shape),
            rng.uniform(-1, 1, (B, 2)).astype(np.float32),
            rng.normal(size=B).astype(np.float32),
            _features(rng, B, f).reshape(B, *cfg.obs_shape),
            rng.random(B) < 0.25)


def _ddpg_updates(name):
    """Two JAX train_once calls (from make_segment's closure) and the same
    two updates in the port, from the same params and batches, with the
    JAX target-policy noise fed in."""
    hp = DDPG_CASES[name]
    twin = hp.get("twin_critic", False)
    jcfg, cfg = JConfig(**LOWDIM), CartpoleConfig(**LOWDIM)
    kw = dict(hidden=HIDDEN, use_batch_norm=True)
    jactor, jcritic = JActor(action_dim=2, **kw), JCritic(**kw)
    k_a, k_c = jax.random.split(jax.random.PRNGKey(21))
    dummy_obs = jnp.zeros((2,) + jcfg.obs_shape, jnp.float32)
    dummy_act = jnp.zeros((2, 2), jnp.float32)
    actor_vars = dict(jactor.init(k_a, dummy_obs))
    if twin:
        critic_vars = jax.vmap(lambda k: dict(jcritic.init(k, dummy_obs, dummy_act)))(
            jax.random.split(k_c, 2))
    else:
        critic_vars = dict(jcritic.init(k_c, dummy_obs, dummy_act))
    assert "batch_stats" in actor_vars and "batch_stats" in critic_vars
    clip = hp.get("grad_clip", 0.0)
    tx = (lambda lr: optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))) if clip \
        else optax.adam
    atx, ctx = tx(LR_A), tx(LR_C)
    jhp = {k: v for k, v in hp.items() if k != "grad_clip"}
    seg = jddpg.make_segment(
        jcommon.make_venv(jcfg, 4), jactor, jcritic, atx, ctx, gamma=GAMMA, tau=TAU,
        batch_size=B, warmup_steps=0, steps_per_segment=1, ou_theta=0.15, ou_sigma=0.2, **jhp)
    train_once = jax.jit(dict(zip(seg.__code__.co_freevars,
                                  (c.cell_contents for c in seg.__closure__)))["train_once"])
    bundles = [(actor_vars, critic_vars, actor_vars, critic_vars,
                atx.init(actor_vars["params"]), ctx.init(critic_vars["params"]))]
    jlosses = []

    actor = Actor(cfg.obs_shape, device="cpu", **kw)
    critic = (TwinCritic if twin else Critic)(cfg.obs_shape, device="cpu", **kw)
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
    port_once = ddpg.make_train_once(cfg, gamma=GAMMA, tau=TAU, warmup_steps=0, **hp)
    losses, states = [], []
    for step in (1, 2):
        batch = _batch(cfg, seed=10 + step)
        k_train = jax.random.PRNGKey(30 + step)
        new, jl, _ = train_once(bundles[-1], tuple(jnp.asarray(x) for x in batch),
                                jnp.ones((B,), jnp.float32), k_train,
                                jnp.asarray(step, jnp.int32))
        bundles.append(jax.device_get(new))
        jlosses.append(jl)
        target_eps = _t(jax.random.normal(jax.random.split(k_train)[1], (B, 2)))
        losses.append(port_once(st, tuple(_t(x) for x in batch), step, target_eps=target_eps))
        states.append({k: copy.deepcopy(getattr(st, k).state_dict()) for k in ddpg.DDPGState._NETS})
    return SimpleNamespace(name=name, twin=twin, bundles=bundles, jlosses=jlosses, st=st,
                           losses=losses, states=states, cfg=cfg)


@pytest.fixture(scope="module", params=list(DDPG_CASES))
def ddpg_bn(request):
    return _ddpg_updates(request.param)


_CONV = {"actor": actor_params_from_flax, "critic": critic_params_from_flax,
         "target_actor": actor_params_from_flax, "target_critic": critic_params_from_flax}
_LR = {"actor": LR_A, "critic": LR_C, "target_actor": LR_A, "target_critic": LR_C}


def _stat_keys(sd):
    return [k for k in sd if k.endswith("batch_norm.mean") or k.endswith("batch_norm.var")]


def test_ddpg_batch_norm_losses_match_jax(ddpg_bn):
    u = ddpg_bn
    for (closs, aloss), jl in zip(u.losses, u.jlosses):
        assert float(closs) == pytest.approx(float(jl["critic_loss"]), rel=2e-2)
        assert float(aloss) == pytest.approx(float(jl["actor_loss"]), rel=2e-2)


@pytest.mark.parametrize("step,bound_lr", [(1, 2.0), (2, 1.0)])
def test_ddpg_batch_norm_params_and_stats_match_jax(ddpg_bn, step, bound_lr):
    """After each update: every parameter within ``bound_lr``·lr of JAX's,
    every running statistic (online and target) at rtol 1e-5."""
    u = ddpg_bn
    jax_state = dict(zip(("actor", "critic", "target_actor", "target_critic"),
                         u.bundles[step][:4]))
    gaps = {}
    for k, tree in jax_state.items():
        want = _CONV[k](tree)
        got = u.states[step - 1][k]
        assert got.keys() == want.keys()
        stats = _stat_keys(got)
        assert len(stats) == (4 if u.twin and "critic" in k else 2)
        for name, v in got.items():
            if name in stats:
                np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=STATS_RTOL,
                                           atol=1e-7, err_msg=f"{k}.{name}")
            else:
                gaps[f"{k}.{name}"] = float((v - want[name]).abs().max()) / _LR[k]
    worst = max(gaps, key=gaps.get)
    print(f"{u.name}, update {step}: largest gap {gaps[worst]:.3f}·lr at {worst}")
    assert gaps[worst] <= bound_lr, (worst, gaps[worst])


def test_ddpg_critic_stats_move_once_per_update(ddpg_bn):
    """The critic's statistics after the first update are one momentum step
    from (0, 1) on the batch's s1 (its loss, in train mode); the actor's
    loss runs it in eval mode and moves them no further.  The actor's own
    moved once too (its forward in train mode); the targets' are the
    Polyak step of the online ones."""
    u = ddpg_bn
    s1 = _t(_batch(u.cfg, seed=11)[0]).reshape(B, -1)
    mean = s1.mean(0)
    var = torch.clamp((s1 * s1).mean(0) - mean * mean, min=0.0)
    want = {"mean": 0.01 * mean, "var": 0.99 + 0.01 * var}
    sd = u.states[0]
    for net in ("actor", "critic"):
        for k in _stat_keys(sd[net]):
            np.testing.assert_allclose(sd[net][k].numpy(), want[k.rsplit(".", 1)[1]].numpy(),
                                       rtol=STATS_RTOL, atol=1e-7, err_msg=f"{net}.{k}")
            init = torch.zeros_like(want["mean"]) if k.endswith("mean") else torch.ones_like(
                want["var"])
            np.testing.assert_allclose(
                sd["target_" + net][k].numpy(), ((1 - TAU) * init + TAU * sd[net][k]).numpy(),
                rtol=STATS_RTOL, atol=1e-7)


def test_ddpg_jax_checkpoint_carries_batch_stats(tmp_path):
    """The JAX DDPG CLI with ``--use-batch-norm --twin-critic`` (low-dim, 4
    envs, 2 segments): every network's statistics come across exactly, the
    twin critics' split from the leading axis of 2, and load into the
    port's networks."""
    parser = jcommon.make_parser("t")
    jddpg.add_ddpg_opts(parser)
    jddpg.train(parser.parse_args(shlex.split(
        """--num-train-batches 2 --num-envs 4 --num-eval 4 --action-repeats 2
        --steps-per-repeat 2 --max-episode-len 10 --steps-per-segment 3 --batch-size 8
        --replay-capacity 64 --warmup-steps 1 --eval-freq 2 --use-batch-norm --twin-critic""")
        + ["--ckpt-dir", str(tmp_path), "--ckpt-freq", "2"]))
    path = tmp_path / "ckpt_2.msgpack"
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    got = ddpg_params_from_jax_checkpoint(str(path))
    cfg = CartpoleConfig(action_repeats=2, **LOWDIM)
    nets = {"actor": Actor, "target_actor": Actor, "critic": TwinCritic,
            "target_critic": TwinCritic}
    for name, cls in nets.items():
        stats = raw[f"{name}_params"]["batch_stats"]["ObsEncoder_0"]["BatchNorm_0"]
        for k in ("mean", "var"):
            want = np.asarray(stats[k])
            if cls is TwinCritic:
                assert want.shape[0] == 2
                for i in range(2):
                    np.testing.assert_array_equal(
                        got[name][f"critics.{i}.encoder.batch_norm.{k}"].numpy(), want[i])
            else:
                np.testing.assert_array_equal(got[name][f"encoder.batch_norm.{k}"].numpy(), want)
        assert float(np.abs(np.asarray(stats["mean"])).max()) > 0.0
        cls(cfg.obs_shape, use_batch_norm=True, device="cpu").load_state_dict(got[name])

"""The port's replay extensions against the JAX package on the CPU:
prioritized sampling (``sample_prioritized``, ``update_priorities``, the
max-priority stamp of ``add_batch``) and n-step returns (``nstep_batch``,
``sample(n_step=)``) — the counterparts of ``tests/test_replay_per.py``
and ``tests/test_nstep.py``, each fed the JAX draws — then DDPG with
``--per``/``--n-step``: one prioritized 3-step update (single and twin
critic) against JAX's ``train_once``, its learning check, the CLI's
capacity check and a skip-replay checkpoint without priorities.

Indices are held equal to JAX's where the priorities sum exactly in
float32 (small integers, α = 1): otherwise the two cumsums may round a
CDF entry differently, and a draw within ulps of a boundary picks the
neighbouring slot, so those cases are held by frequencies.  Gathers move
values without arithmetic and match exactly; n-step returns and
importance weights match to float32 rounding (rtol 1e-6 and 1e-5).
"""

import shlex
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
from cartpoleplusplus_tpu.replay import buffer as jbuffer
from cartpoleplusplus_tpu_torch.agents import ddpg
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.models.networks import Actor, Critic, TwinCritic
from cartpoleplusplus_tpu_torch.replay import buffer
from cartpoleplusplus_tpu_torch.utils import checkpoint as ckpt
from cartpoleplusplus_tpu_torch.utils.params import actor_params_from_flax, critic_params_from_flax

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _filled(capacity=8, n=8, block=0):
    """tests/test_replay_per.py's ``_filled``, in both packages: row i holds
    obs i, reward i (s2 = obs + 0.5 in explicit mode)."""
    jr = jbuffer.create(capacity, (3,), (), block=block, prioritized=True)
    tr = buffer.create(capacity, (3,), (), block=block, prioritized=True)
    b = max(block, 1)
    for i in range(0, n, b):
        obs = np.full((b, 3), float(i), np.float32)
        rew = np.full((b,), float(i), np.float32)
        s2 = None if block else obs + 0.5
        jr = jbuffer.add_batch(jr, jnp.asarray(obs), jnp.zeros((b,)), jnp.asarray(rew),
                               None if block else jnp.asarray(s2), jnp.zeros((b,), bool))
        buffer.add_batch(tr, _t(obs), torch.zeros(b), _t(rew), None if block else _t(s2),
                         torch.zeros(b, dtype=torch.bool))
    return jr, tr


def _set_priority(jr, tr, pri):
    pri = np.asarray(pri, np.float32)
    tr.priority[: pri.shape[0]] = _t(pri)
    return jr.replace(priority=jr.priority.at[: pri.shape[0]].set(jnp.asarray(pri)))


def _both(jr, tr, key, n, alpha, beta, **kw):
    """JAX's sample_prioritized with ``key`` and the port's fed JAX's draws."""
    want = jbuffer.sample_prioritized(jr, key, n, alpha, beta, **kw)
    u = _t(jax.random.uniform(key, (n,)))
    got = buffer.sample_prioritized(tr, n, alpha, beta, u=u, **kw)
    return got, want


def test_insert_stamps_max_priority():
    jr, tr = _filled(n=4)
    assert torch.equal(tr.priority, _t(jr.priority))
    jr = jbuffer.update_priorities(jr, jnp.array([0, 1]), jnp.array([1.99, 0.09]), eps=0.01)
    buffer.update_priorities(tr, torch.tensor([0, 1]), torch.tensor([1.99, 0.09]), eps=0.01)
    jr = jbuffer.add_batch(jr, jnp.zeros((1, 3)), jnp.zeros((1,)), jnp.zeros((1,)),
                           jnp.zeros((1, 3)), jnp.zeros((1,), bool))
    buffer.add_batch(tr, torch.zeros(1, 3), torch.zeros(1), torch.zeros(1), torch.zeros(1, 3),
                     torch.zeros(1, dtype=torch.bool))
    np.testing.assert_allclose(float(tr.priority[4]), 2.0)
    np.testing.assert_array_equal(tr.priority.numpy(), np.asarray(jr.priority))


def test_proportional_sampling_frequencies():
    """Integer priorities at α = 1 sum exactly: the same indices as JAX."""
    jr, tr = _filled()
    pri = [8.0, 4.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    jr = _set_priority(jr, tr, pri)
    draws = 40000
    (batch, idx, iw), (jbatch, jidx, jiw) = _both(jr, tr, jax.random.PRNGKey(0), draws, 1.0, 0.0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for g, w in zip(batch, jbatch):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(iw.numpy(), np.asarray(jiw), rtol=1e-6)
    counts = np.bincount(idx.numpy(), minlength=8) / draws
    np.testing.assert_allclose(counts, np.asarray(pri) / sum(pri), atol=0.01)


def test_importance_weights_match_probabilities():
    """α = 0.7: the JAX test's own check on the port's draws, and the
    frequencies against JAX's."""
    jr, tr = _filled()
    pri = np.arange(1.0, 9.0)
    jr = _set_priority(jr, tr, pri)
    alpha, beta = 0.7, 1.0
    (_, idx, iw), (_, jidx, _) = _both(jr, tr, jax.random.PRNGKey(1), 512, alpha, beta)
    w = pri ** alpha
    p = w / w.sum()
    expected = (8 * p[idx.numpy()]) ** (-beta)
    np.testing.assert_allclose(iw.numpy(), expected / expected.max(), rtol=1e-5)
    assert float(iw.max()) <= 1.0 + 1e-6
    assert np.mean(idx.numpy() == np.asarray(jidx)) >= 0.99
    (_, idx, _), (_, jidx, _) = _both(jr, tr, jax.random.PRNGKey(11), 40000, alpha, beta)
    np.testing.assert_allclose(np.bincount(idx.numpy(), minlength=8) / 40000,
                               np.bincount(np.asarray(jidx), minlength=8) / 40000, atol=0.005)


def test_uniform_priorities_give_unit_weights():
    jr, tr = _filled()
    (_, idx, iw), (_, jidx, jiw) = _both(jr, tr, jax.random.PRNGKey(2), 64, 0.6, 1.0)
    np.testing.assert_allclose(iw.numpy(), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_alpha_zero_is_uniform_over_valid_only():
    """A half-filled ring at α = 0: every valid slot equally likely (the
    weights 1 sum exactly: JAX's indices), no invalid slot ever drawn."""
    jr, tr = _filled(capacity=16, n=8)
    jr = _set_priority(jr, tr, [9.0, 1.0, 5.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    (_, idx, _), (_, jidx, _) = _both(jr, tr, jax.random.PRNGKey(3), 20000, 0.0, 0.5)
    idx = idx.numpy()
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    assert idx.max() < 8
    np.testing.assert_allclose(np.bincount(idx, minlength=8) / 20000, 1.0 / 8.0, atol=0.02)


def test_s2free_excludes_newest_block():
    jr, tr = _filled(capacity=8, n=8, block=2)
    assert tr.block == 2 and tr.cursor == 0 and tr.size == 8
    pri = np.ones(8, np.float32)
    pri[6:8] = 1e6
    jr = _set_priority(jr, tr, pri)
    (batch, idx, _), (jbatch, jidx, _) = _both(jr, tr, jax.random.PRNGKey(4), 4096, 1.0, 0.0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert not np.isin(idx.numpy(), [6, 7]).any()
    mask, count = buffer.valid_mask(tr)
    jmask, jcount = jbuffer._valid_mask(jr)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert count == int(jcount) == 6
    for g, w in zip(batch, jbatch):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("gate", [None, True, False])
def test_priority_updates_match_jax(gate):
    """A sample, |reward| as the TD stand-in, the write-back (gated
    like the agents' train gate): the same priority row as JAX."""
    jr, tr = _filled()
    key = jax.random.PRNGKey(5)
    (batch, idx, _), (jbatch, jidx, _) = _both(jr, tr, key, 4, 0.6, 0.4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jgate = None if gate is None else jnp.asarray(gate)
    jr2 = jbuffer.update_priorities(jr, jidx, jnp.abs(jbatch[2]), gate=jgate)
    buffer.update_priorities(tr, idx, batch[2].abs(), gate=gate)
    np.testing.assert_allclose(tr.priority.numpy(), np.asarray(jr2.priority), rtol=1e-6)
    got = tr.priority.numpy()[idx.numpy()]
    want = (np.abs(tr.reward.numpy()[idx.numpy()]) + 1e-2) if gate is not False else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _block_buffers(capacity=16, block=2, steps=8, term_at=()):
    """tests/test_nstep.py's ``_block_buffer`` in both packages: step t
    writes rewards (10t, 10t + 1) and obs t; terminals at (step, slot)."""
    jr = jbuffer.create(capacity, (3,), (), block=block)
    tr = buffer.create(capacity, (3,), (), block=block)
    for t in range(steps):
        rew = np.array([10.0 * t, 10.0 * t + 1.0], np.float32)
        term = np.array([(t, s) in term_at for s in range(block)])
        obs = np.full((block, 3), float(t), np.float32)
        jr = jbuffer.add_batch(jr, jnp.asarray(obs), jnp.zeros((block,)), jnp.asarray(rew), None,
                               jnp.asarray(term))
        buffer.add_batch(tr, _t(obs), torch.zeros(block), _t(rew), None, _t(term))
    return jr, tr


def _nstep_all(jr, tr, n, gamma):
    """Every row through both ``nstep_batch``es → the port's batch."""
    idx = np.arange(tr.capacity)
    got = buffer.nstep_batch(tr, _t(idx), n, gamma)
    want = jbuffer.nstep_batch(jr, jnp.asarray(idx), n, gamma)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        assert g.numpy().dtype == np.asarray(w).dtype
    return got


def test_nstep_accumulates_rewards_with_discount():
    jr, tr = _block_buffers()
    gamma = 0.9
    s1, _, rn, s2, done = (x[2] for x in _nstep_all(jr, tr, 3, gamma))
    np.testing.assert_allclose(float(rn), 10.0 + gamma * 20.0 + gamma**2 * 30.0, rtol=1e-6)
    assert not bool(done)
    np.testing.assert_allclose(s1.numpy(), 1.0)
    np.testing.assert_allclose(s2.numpy(), 4.0)


def test_nstep_masks_rewards_past_terminal():
    jr, tr = _block_buffers(term_at={(2, 0)})
    gamma = 0.5
    _, _, rn, _, done = _nstep_all(jr, tr, 3, gamma)
    np.testing.assert_allclose(float(rn[2]), 10.0 + gamma * 20.0, rtol=1e-6)
    assert bool(done[2])
    np.testing.assert_allclose(float(rn[4]), 20.0, rtol=1e-6)
    assert bool(done[4])


def _sample_offsets(jr, key, n, n_step):
    valid = max(int(jr.size) - n_step * jr.block, 1)
    return _t(jax.random.randint(key, (n,), 0, valid)).to(torch.int64)


def test_nstep_one_equals_plain_sample():
    jr, tr = _block_buffers()
    key = jax.random.PRNGKey(0)
    off = _sample_offsets(jr, key, 32, 1)
    a = buffer.sample(tr, 32, offsets=off, n_step=1, gamma=0.9)
    b = buffer.sample(tr, 32, offsets=off)
    want = jbuffer.sample(jr, key, 32, n_step=1, gamma=0.9)
    for x, y, w in zip(a, b, want):
        assert torch.equal(x, y)
        np.testing.assert_array_equal(x.numpy(), np.asarray(w))


def test_nstep_sampling_excludes_newest_n_blocks():
    jr, tr = _block_buffers(capacity=16, steps=8)
    key = jax.random.PRNGKey(1)
    got = buffer.sample(tr, 4096, offsets=_sample_offsets(jr, key, 4096, 3), n_step=3, gamma=0.9)
    want = jbuffer.sample(jr, key, 4096, n_step=3, gamma=0.9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert float(got[0].max()) <= 4.0
    drawn = buffer.sample(tr, 4096, torch.Generator().manual_seed(0), n_step=3, gamma=0.9)
    assert float(drawn[0].max()) <= 4.0


def test_nstep_prioritized_path_matches_uniform_fields():
    jr, tr = _block_buffers()
    jr = jr.replace(priority=jnp.ones((16,)))
    tr.priority = torch.ones(16)
    (batch, idx, iw), (jbatch, jidx, _) = _both(jr, tr, jax.random.PRNGKey(2), 64, 0.6, 1.0,
                                                n_step=2, gamma=0.8)
    np.testing.assert_allclose(iw.numpy(), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    ref = buffer.nstep_batch(tr, idx, 2, 0.8)
    for x, y, w in zip(batch, ref, jbatch):
        assert torch.equal(x, y)
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=1e-6)


# One prioritized 3-step DDPG update against JAX's train_once (low-dim, a
# narrow trunk): the loss within test_torch_ddpg.py's rtol 2e-2, |TD| per
# sample within 2e-2 of its scale (the critics compute in bfloat16).
LOWDIM = dict(discrete_actions=False)
HIDDEN = (32, 16)
B, N_STEP, GAMMA = 16, 3, 0.99


@pytest.mark.parametrize("twin", [False, True])
def test_per_update_matches_jax(twin):
    jcfg, cfg = JConfig(**LOWDIM), CartpoleConfig(**LOWDIM)
    jactor, jcritic = JActor(action_dim=2, hidden=HIDDEN), JCritic(hidden=HIDDEN)
    k_a, k_c, k_train = jax.random.split(jax.random.PRNGKey(21), 3)
    dummy_obs, dummy_act = jnp.zeros((2,) + jcfg.obs_shape), jnp.zeros((2, 2))
    actor_vars = dict(jactor.init(k_a, dummy_obs))
    if twin:
        critic_vars = jax.vmap(lambda k: dict(jcritic.init(k, dummy_obs, dummy_act)))(
            jax.random.split(k_c, 2))
    else:
        critic_vars = dict(jcritic.init(k_c, dummy_obs, dummy_act))
    atx, ctx = optax.adam(1e-4), optax.adam(1e-3)
    seg = jddpg.make_segment(
        jcommon.make_venv(jcfg, 4), jactor, jcritic, atx, ctx, gamma=GAMMA, tau=0.005,
        batch_size=B, warmup_steps=0, steps_per_segment=1, ou_theta=0.15, ou_sigma=0.2,
        twin_critic=twin, per_alpha=0.6, n_step=N_STEP)
    train_once = dict(zip(seg.__code__.co_freevars, (c.cell_contents for c in seg.__closure__)))[
        "train_once"]
    rng = np.random.default_rng(3)
    batch = (rng.normal(size=(B, *cfg.obs_shape)).astype(np.float32),
             rng.uniform(-1, 1, (B, 2)).astype(np.float32),
             rng.normal(size=B).astype(np.float32) * 3.0,
             rng.normal(size=(B, *cfg.obs_shape)).astype(np.float32),
             rng.random(B) < 0.25)
    iw = rng.uniform(0.2, 1.0, B).astype(np.float32)
    bundle = (actor_vars, critic_vars, actor_vars, critic_vars,
              atx.init(actor_vars["params"]), ctx.init(critic_vars["params"]))
    _, losses, jtd = jax.jit(train_once)(bundle, tuple(jnp.asarray(x) for x in batch),
                                         jnp.asarray(iw), k_train, jnp.asarray(1, jnp.int32))
    kw = dict(hidden=HIDDEN, device="cpu")
    actor = Actor(cfg.obs_shape, **kw)
    critic = (TwinCritic if twin else Critic)(cfg.obs_shape, **kw)
    actor.load_state_dict(actor_params_from_flax(jax.device_get(actor_vars)))
    critic.load_state_dict(critic_params_from_flax(jax.device_get(critic_vars)))
    (aopt, asch), (copt, csch) = ddpg.adam(actor, 1e-4), ddpg.adam(critic, 1e-3)
    st = ddpg.DDPGState(
        actor=actor, critic=critic, target_actor=Actor(cfg.obs_shape, **kw),
        target_critic=(TwinCritic if twin else Critic)(cfg.obs_shape, **kw),
        actor_opt=aopt, critic_opt=copt, actor_sched=asch, critic_sched=csch, replay=None,
        env_states=None, obs=None, ou_noise=None, generator=torch.Generator().manual_seed(0))
    st.target_actor.load_state_dict(actor.state_dict())
    st.target_critic.load_state_dict(critic.state_dict())
    port_once = ddpg.make_train_once(cfg, gamma=GAMMA, tau=0.005, warmup_steps=0,
                                     twin_critic=twin, n_step=N_STEP)
    closs, aloss, td = port_once(st, tuple(_t(x) for x in batch), 1, iw=_t(iw))
    assert float(closs) == pytest.approx(float(losses["critic_loss"]), rel=2e-2)
    assert float(aloss) == pytest.approx(float(losses["actor_loss"]), rel=2e-2)
    jtd = np.asarray(jtd)
    assert td.shape == (B,) and jtd.shape == (B,)
    np.testing.assert_allclose(td.numpy(), jtd, rtol=0, atol=2e-2 * np.abs(jtd).max())
    # Without iw the same update's loss is the unweighted mean.
    assert len(port_once(st, tuple(_t(x) for x in batch), 2)) == 2


def test_segment_writes_priorities_back():
    """A prioritized 3-step segment of the plain versions: inserts stamp the
    running max, each update writes |TD| + eps back, the gate waits for
    n + 1 blocks."""
    from cartpoleplusplus_tpu_torch.agents.common import make_venv

    cfg = CartpoleConfig(**LOWDIM)
    venv = make_venv(cfg, 8, device="cpu")
    st = ddpg.init_state(SimpleNamespace(seed=0, replay_capacity=48, per=True), cfg, venv,
                         hidden=HIDDEN)
    assert st.replay.prioritized and st.replay.block == 8
    seg = ddpg.make_segment(venv, gamma=GAMMA, tau=0.005, batch_size=8, warmup_steps=0,
                            steps_per_segment=6, ou_theta=0.15, ou_sigma=0.2, per_alpha=0.6,
                            per_total_steps=12, per_eps=0.05, n_step=3)
    m = seg(st)
    # min fill: 4 blocks of 8 → updates at steps 4, 5 and 6.
    assert m["updates"] == 3 and st.replay.size == 48
    assert float(st.replay.priority.min()) >= 0.05
    assert not torch.all(st.replay.priority == st.replay.priority[0])


SMOKE = """--num-train-batches 60 --reward-scale 0.1 --grad-clip 10.0 --per --n-step 3
  --num-envs 32 --num-eval 32 --action-repeats 2 --steps-per-repeat 3
  --max-episode-len 60 --eval-freq 20 --steps-per-segment 25 --batch-size 64
  --replay-capacity 4096 --warmup-steps 10 --seed 0"""


def test_ddpg_per_nstep_improves():
    """The counterpart of tests/test_nstep.py::test_ddpg_per_nstep_improves,
    same flags and gate (an untrained policy evals at ~7-8 steps on this
    60-step horizon)."""
    final = ddpg.main(["--device", "cpu", *shlex.split(SMOKE)])
    assert final > 12.0, f"PER/n-step DDPG did not learn: eval len {final}"


def test_nstep_rejects_degenerate_capacity():
    """capacity < (n + 1) blocks stops the DDPG CLI with JAX's words, and a
    replay too small for the s2-free layout with JAX's other message."""
    toy = shlex.split("""--device cpu --n-step 2 --num-envs 4 --num-train-batches 1
      --num-eval 4 --action-repeats 2 --steps-per-repeat 2 --max-episode-len 10
      --steps-per-segment 2 --batch-size 4 --warmup-steps 1""")
    with pytest.raises(SystemExit, match="needs replay capacity"):
        ddpg.main([*toy, "--replay-capacity", "8"])
    with pytest.raises(SystemExit, match="needs the s2-free block replay"):
        ddpg.main([*toy, "--replay-capacity", "4"])


def _opts(ckpt_dir, n, *extra):
    return ddpg.make_parser().parse_args(shlex.split(f"""--device cpu --num-train-batches {n}
      --num-envs 4 --num-eval 4 --action-repeats 2 --steps-per-repeat 2
      --max-episode-len 10 --steps-per-segment 3 --batch-size 8 --replay-capacity 64
      --warmup-steps 1 --eval-freq 1 --ckpt-dir {ckpt_dir} --ckpt-freq 1 --per --n-step 2""")
        + list(extra))


def test_skip_replay_checkpoint_drops_priorities(tmp_path):
    """A prioritized run's checkpoint holds its priorities; a skip-replay
    file drops them with the data, and its resume starts from a fresh
    buffer of ones."""
    ddpg.train(_opts(tmp_path / "full", 2))
    full = ckpt.load_raw(str(tmp_path / "full"), 2)
    assert full["replay"]["priority"].shape == (64,)
    assert float(full["replay"]["priority"].max()) > 0.0
    ddpg.train(_opts(tmp_path / "lean", 2, "--ckpt-skip-replay"))
    lean = ckpt.load_raw(str(tmp_path / "lean"), 2)
    assert lean["replay"]["priority"].shape == (0,)
    assert lean["replay"]["size"] == 0
    cfg = CartpoleConfig(action_repeats=2, steps_per_repeat=2, max_episode_len=10, **LOWDIM)
    from cartpoleplusplus_tpu_torch.agents.common import make_venv

    st = ddpg.init_state(SimpleNamespace(seed=0, replay_capacity=64, per=True), cfg,
                         make_venv(cfg, 4, device="cpu"))
    st, step = ckpt.restore_latest(str(tmp_path / "lean"), st)
    assert step == 2 and st.replay.size == 0
    assert torch.equal(st.replay.priority, torch.ones(64))
    st, _ = ckpt.restore_latest(str(tmp_path / "full"), st)
    assert torch.equal(st.replay.priority, full["replay"]["priority"])

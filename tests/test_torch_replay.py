"""The port's uniform replay (replay/buffer.py), OU noise, the replay-sizing
and schedule helpers of agents/common.py, against the JAX package on the
CPU.

Replay writes and gathers move values without arithmetic, so contents,
cursor, fill level and sampled batches must match exactly; the sample
offsets are drawn with the JAX key and handed to the port.  OU noise gets
the same standard normals on both sides and matches to float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.replay import buffer as jbuffer
from cartpoleplusplus_tpu.utils import noise as jnoise
from cartpoleplusplus_tpu_torch.agents import common
from cartpoleplusplus_tpu_torch.replay import buffer
from cartpoleplusplus_tpu_torch.utils import noise

torch.set_num_threads(2)

OBS = (3, 5)
BATCH = 16


def _batches(n, b, seed=0):
    """n insert batches of b transitions: uint8 obs, actions, rewards, flags."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, *OBS), dtype=np.uint8),
             rng.uniform(-1, 1, (b, 2)).astype(np.float32),
             rng.normal(size=b).astype(np.float32),
             rng.integers(0, 256, (b, *OBS), dtype=np.uint8),
             rng.random(b) < 0.3) for _ in range(n)]


def _assert_same(jr, tr):
    assert (tr.cursor, tr.size, tr.capacity) == (int(jr.cursor), int(jr.size), jr.capacity)
    for f in ("s1", "action", "reward", "terminal"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)))
    if not tr.block:
        np.testing.assert_array_equal(tr.s2.numpy(), np.asarray(jr.s2))


def _sample_both(jr, tr, key):
    """JAX's sample with ``key`` and the port's with the same offsets."""
    valid = max(int(jr.size) - jr.block, 1)
    off = jax.random.randint(key, (BATCH,), 0, valid)
    want = jbuffer.sample(jr, key, BATCH)
    got = buffer.sample(tr, BATCH, offsets=torch.from_numpy(np.asarray(off).astype(np.int64)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("block,capacity,b,inserts", [
    (4, 12, 4, 7),   # s2-free through two wraps of the ring
    (0, 10, 3, 6),   # general mode, batches wrapping mid-write
    (0, 10, 1, 4),   # general mode, one transition at a time
])
def test_replay_matches_jax(block, capacity, b, inserts):
    jr = jbuffer.create(capacity, OBS, (2,), obs_dtype=jnp.uint8, block=block)
    tr = buffer.create(capacity, OBS, (2,), obs_dtype=torch.uint8, block=block)
    key = jax.random.PRNGKey(block + capacity)
    for i, (s1, a, r, s2, t) in enumerate(_batches(inserts, b)):
        jr = jbuffer.add_batch(jr, jnp.asarray(s1), jnp.asarray(a), jnp.asarray(r),
                               None if block else jnp.asarray(s2), jnp.asarray(t))
        buffer.add_batch(tr, torch.from_numpy(s1), torch.from_numpy(a), torch.from_numpy(r),
                         None if block else torch.from_numpy(s2), torch.from_numpy(t))
        _assert_same(jr, tr)
        _sample_both(jr, tr, jax.random.fold_in(key, i))


def test_s2_free_never_samples_the_newest_block():
    """Every draw from the s2-free ring skips the newest block and pairs s1
    with the same env slot's next row, before and after the ring fills."""
    block, capacity = 4, 12
    tr = buffer.create(capacity, OBS, (2,), obs_dtype=torch.uint8, block=block)
    for step, (s1, a, r, _, t) in enumerate(_batches(5, block)):
        s1[:, 0, 0] = step  # tag each row with its insert step
        buffer.add_batch(tr, torch.from_numpy(s1), torch.from_numpy(a), torch.from_numpy(r),
                         None, torch.from_numpy(t))
        valid = max(tr.size - block, 1)
        got_s1, _, _, got_s2, _ = buffer.sample(tr, valid, offsets=torch.arange(valid))
        if step == 0:
            continue  # one block written: the clamped draw is row 0, as in JAX
        steps = got_s1[:, 0, 0].tolist()
        assert step not in steps  # the newest block has no successor yet
        assert sorted(set(steps)) == list(range(max(step - 2, 0), step))
        assert got_s2[:, 0, 0].tolist() == [s + 1 for s in steps]
        offsets = buffer.sample_offsets(tr, 64, torch.Generator().manual_seed(step))
        assert int(offsets.min()) >= 0 and int(offsets.max()) < valid


@pytest.mark.parametrize("capacity,block", [(8, 4), (12, 4), (12, 3), (10, 0)])
def test_create_matches_jax(capacity, block):
    """Capacities that are multiples of the block: the same shapes as JAX."""
    j = jbuffer.create(capacity, OBS, (2,), block=block)
    t = buffer.create(capacity, OBS, (2,), block=block)
    assert t.capacity == j.capacity == capacity
    assert t.s2.shape == tuple(j.s2.shape)


@pytest.mark.parametrize("capacity,block", [(4, 4), (4, -1), (10, 4), (7, 4), (5, 4)])
def test_create_rejects_bad_blocks(capacity, block):
    """A block that leaves no second block, a negative one, and (unlike
    JAX, which trims) a capacity that is not a multiple of the block."""
    with pytest.raises(ValueError):
        buffer.create(capacity, OBS, (2,), block=block)


def test_block_mode_rejects_other_batch_sizes():
    tr = buffer.create(12, OBS, (2,), obs_dtype=torch.uint8, block=4)
    s1, a, r, _, t = _batches(1, 3)[0]
    with pytest.raises(ValueError, match="fixed batch 4"):
        buffer.add_batch(tr, torch.from_numpy(s1), torch.from_numpy(a), torch.from_numpy(r),
                         None, torch.from_numpy(t))


@pytest.mark.parametrize("warmup,envs,capacity,n_step", [
    (0, 4096, 8192, 1),   # the bench rows: the ring must be full
    (20, 64, 100000, 1),  # the agents' defaults
    (5, 16, 64, 1),       # warm-up capped one block below capacity
    (0, 16, 16, 1),       # the floor capped at capacity
    (3, 8, 80, 3),        # the n-step floor
])
def test_replay_min_fill_matches_jax(warmup, envs, capacity, n_step):
    assert (common.replay_min_fill(warmup, envs, capacity, n_step)
            == jcommon.replay_min_fill(warmup, envs, capacity, n_step))


@pytest.mark.parametrize("envs,capacity", [
    (4096, 8192), (4096, 4096), (64, 100000), (64, 128), (0, 10), (8, 64), (8, 8),
])
def test_replay_block_matches_jax(envs, capacity):
    """One card: the JAX helper with its default single device."""
    class Opts:
        replay_capacity = capacity

    assert common.replay_block(Opts, envs) == jcommon.replay_block(Opts, envs)


def test_encode_decode_match_jax():
    x = np.random.default_rng(1).uniform(-0.2, 1.2, (6, *OBS)).astype(np.float32)
    for dtype, jdtype in ((torch.uint8, jnp.uint8), (torch.float32, jnp.float32)):
        enc = buffer.encode_obs(torch.from_numpy(x), dtype)
        jenc = jbuffer.encode_obs(jnp.asarray(x), jdtype)
        np.testing.assert_array_equal(enc.numpy(), np.asarray(jenc))
        np.testing.assert_array_equal(buffer.decode_obs(enc).numpy(),
                                      np.asarray(jbuffer.decode_obs(jenc)))
    u8 = torch.from_numpy((x * 200).clip(0, 255).astype(np.uint8))
    assert buffer.encode_obs(u8, torch.uint8) is u8  # rendered frames pass through


def test_ou_step_matches_jax():
    """Same ε on both sides (the JAX step's own normals, drawn from its key)."""
    key = jax.random.PRNGKey(3)
    state = np.random.default_rng(2).normal(size=(32, 2)).astype(np.float32)
    eps = jax.random.normal(key, state.shape, jnp.float32)
    want = jnoise.ou_step(jnp.asarray(state), key, theta=0.15, sigma=0.2)
    got = noise.ou_step(torch.from_numpy(state), 0.15, 0.2, eps=torch.from_numpy(np.array(eps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert torch.equal(noise.ou_init((4, 2)), torch.zeros((4, 2)))
    drawn = noise.ou_step(torch.zeros(4096, 2), generator=torch.Generator().manual_seed(0))
    assert abs(float(drawn.std()) - 0.2) < 0.01  # σ·N(0, 1) from a zero state


@pytest.mark.parametrize("steps,sigma_min,decay", [
    (0, 0.05, 100), (50, 0.05, 100), (250, 0.05, 100), (10, None, 100), (10, 0.05, 0),
])
def test_ou_sigma_at_matches_jax(steps, sigma_min, decay):
    want = jcommon.ou_sigma_at(jnp.asarray(steps, jnp.int32), 0.2, sigma_min, decay)
    assert common.ou_sigma_at(steps, 0.2, sigma_min, decay) == pytest.approx(float(want), abs=1e-7)


def test_make_lr_matches_optax():
    class Opts:
        lr_schedule = "cosine"
        num_train_batches = 5
        steps_per_segment = 4

    sched = common.make_lr(Opts, 1e-3)
    want = jcommon.make_lr(Opts, 1e-3)
    for count in (0, 1, 7, 19, 20, 40):
        assert sched(count) == pytest.approx(float(want(count)), rel=1e-6)
    Opts.lr_schedule = "const"
    assert common.make_lr(Opts, 1e-3) == 1e-3 == jcommon.make_lr(Opts, 1e-3)
    assert callable(optax.cosine_decay_schedule(1e-3, 20, alpha=0.02))

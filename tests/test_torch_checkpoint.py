"""Checkpoint / resume of the port (``utils/checkpoint.py`` and DDPG's
``train``), the counterparts of the JAX package's ``tests/test_checkpoint.py``
on the port's own file format (``torch.save`` of nested dicts, loadable
with ``weights_only=True``).  The agent-level tests drive the port's
``train`` on the CPU at a toy size (4 low-dim envs, 3 steps a segment).
"""

import json
import os
import shutil
from types import SimpleNamespace

import pytest
import torch

from cartpoleplusplus_tpu_torch.agents import common, ddpg
from cartpoleplusplus_tpu_torch.replay import buffer
from cartpoleplusplus_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)


def _opts(ckpt_dir, num_train_batches, *extra):
    return ddpg.make_parser().parse_args([
        "--device", "cpu",
        "--num-train-batches", str(num_train_batches),
        "--num-envs", "4", "--num-eval", "4",
        "--action-repeats", "2", "--steps-per-repeat", "2",
        "--max-episode-len", "10", "--steps-per-segment", "3",
        "--batch-size", "8", "--replay-capacity", "64", "--warmup-steps", "1",
        "--eval-freq", "1", "--ckpt-dir", str(ckpt_dir), "--ckpt-freq", "1", *extra,
    ])


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


def test_save_restore_roundtrip(tmp_path):
    tree = {
        "params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)},
        "step": 7,
        "rng": torch.Generator().manual_seed(3).get_state(),
    }
    ckpt.save(str(tmp_path), 10, tree)
    target = {"params": {"w": torch.zeros(2, 3), "b": torch.zeros(3)}, "step": 0,
              "rng": torch.zeros_like(tree["rng"])}
    restored, step = ckpt.restore_latest(str(tmp_path), target)
    assert step == 10
    _equal(restored, tree)
    # Every file is a plain tensor container.
    torch.load(tmp_path / "ckpt_10.pt", weights_only=True)


def test_restore_latest_picks_newest(tmp_path):
    for step in (5, 20, 10):
        ckpt.save(str(tmp_path), step, {"v": torch.tensor(float(step))})
    restored, step = ckpt.restore_latest(str(tmp_path), {"v": torch.tensor(0.0)})
    assert step == 20
    assert float(restored["v"]) == 20.0


def test_restore_missing_dir_returns_target(tmp_path):
    target = {"v": torch.tensor(1.5)}
    restored, step = ckpt.restore_latest(str(tmp_path / "nope"), target)
    assert step is None
    assert restored is target


def test_agent_level_resume(tmp_path):
    """DDPG trains, checkpoints, restarts from the checkpoint and continues.

    Resume carries the segment counter: run 2 with a higher
    --num-train-batches picks up at run 1's last segment and numbers new
    checkpoints after it, never re-saving ckpt_1..N with newer weights
    under older names; a complete re-run trains nothing and clobbers
    nothing.
    """
    ddpg.train(_opts(tmp_path, 2))
    assert ckpt.latest_step(str(tmp_path)) == 2
    raw1 = ckpt.load_raw(str(tmp_path), 2)
    steps_run1 = int(raw1["env_steps"])
    assert steps_run1 == 2 * 3  # 2 segments × 3 steps

    ddpg.train(_opts(tmp_path, 4))
    assert ckpt.latest_step(str(tmp_path)) == 4
    raw2 = ckpt.load_raw(str(tmp_path), 4)
    assert int(raw2["env_steps"]) == steps_run1 + 2 * 3
    mtime1 = os.path.getmtime(tmp_path / "ckpt_1.pt")

    ddpg.train(_opts(tmp_path, 4))
    assert ckpt.latest_step(str(tmp_path)) == 4
    raw3 = ckpt.load_raw(str(tmp_path), 4)
    assert int(raw3["env_steps"]) == steps_run1 + 2 * 3
    _equal(raw3["actor"], raw2["actor"])
    assert os.path.getmtime(tmp_path / "ckpt_1.pt") == mtime1


@pytest.mark.parametrize("extra", [(), ("--twin-critic", "--policy-delay", "2", "--target-noise",
                                        "0.2", "--lr-schedule", "cosine", "--grad-clip", "10")])
def test_resume_is_exact(tmp_path, extra):
    """A run of 4 segments resumed from its own ckpt_2 ends in the state it
    ended in, byte for byte: networks, targets, optimizers, learning-rate
    schedules, replay, env states, obs, OU noise and the generator all
    round-trip.  (Resumed from the same --num-train-batches: the cosine
    schedule's length is the run's.)"""
    ddpg.train(_opts(tmp_path / "once", 4, *extra))
    os.makedirs(tmp_path / "resumed")
    shutil.copy(tmp_path / "once" / "ckpt_2.pt", tmp_path / "resumed" / "ckpt_2.pt")
    ddpg.train(_opts(tmp_path / "resumed", 4, *extra))
    once = ckpt.load_raw(str(tmp_path / "once"), 4)
    resumed = ckpt.load_raw(str(tmp_path / "resumed"), 4)
    _equal(once, resumed)
    assert once["replay"]["size"] == 4 * 3 * 4


def test_skip_replay_checkpoint(tmp_path):
    """--ckpt-skip-replay drops the buffer from the file; resume restores
    params, optimizer, env and generator exactly and restarts with a fresh
    empty buffer."""
    ddpg.train(_opts(tmp_path / "full", 2))
    ddpg.train(_opts(tmp_path / "lean", 2, "--ckpt-skip-replay"))
    full_size = os.path.getsize(tmp_path / "full" / "ckpt_2.pt")
    lean_size = os.path.getsize(tmp_path / "lean" / "ckpt_2.pt")
    assert lean_size < full_size
    raw = ckpt.load_raw(str(tmp_path / "lean"), 2)
    assert raw["replay"]["s1"].shape == (0,)
    assert raw["replay"]["size"] == 0 and raw["replay"]["cursor"] == 0

    final = ddpg.train(_opts(tmp_path / "lean", 4, "--ckpt-skip-replay"))
    assert ckpt.latest_step(str(tmp_path / "lean")) == 4
    assert final == final  # finite, not NaN


def test_skip_replay_resume_rewarms_before_training(tmp_path):
    """After a --ckpt-skip-replay resume the buffer is empty though
    env_steps restored large; the train gate waits for it to re-fill
    (replay_min_fill) instead of training on unwritten rows."""
    warm = ("--ckpt-skip-replay", "--warmup-steps", "5")  # min_fill 5·4 + 4 = 24 > 12
    ddpg.train(_opts(tmp_path, 2, *warm))
    before = ckpt.load_raw(str(tmp_path), 2)
    # One resumed segment = 3 steps × 4 envs = 12 transitions: not warm yet,
    # so the actor comes through bit-identical.
    ddpg.train(_opts(tmp_path, 3, *warm))
    after = ckpt.load_raw(str(tmp_path), 3)
    _equal(after["actor"], before["actor"])
    # Two more segments push the refill past min_fill: training resumes.
    ddpg.train(_opts(tmp_path, 5, *warm))
    final = ckpt.load_raw(str(tmp_path), 5)
    assert any(not torch.equal(final["actor"][k], before["actor"][k]) for k in before["actor"])


def test_replay_subtree_restores_as_unit(tmp_path):
    """If the replay's data cannot restore (another capacity, a skip-replay
    file), its cursor and size reset with it, or the train gate would open
    on unwritten rows; a same-shape replay restores whole."""
    old = buffer.create(96, (3,), (), block=8)
    for t in range(11):
        buffer.add_batch(old, torch.full((8, 3), float(t)), torch.zeros(8), torch.zeros(8), None,
                         torch.zeros(8, dtype=torch.bool))
    st = {"replay": {k: getattr(old, k) for k in ("s1", "action", "reward", "s2", "terminal",
                                                  "cursor", "size", "block")},
          "env_steps": 500}
    ckpt.save(str(tmp_path), 1, st)
    fresh = buffer.create(80, (3,), (), block=8)
    target = {"replay": {k: getattr(fresh, k) for k in st["replay"]}, "env_steps": 0}
    restored, step = ckpt.restore_latest(str(tmp_path), target)
    assert step == 1 and restored["env_steps"] == 500
    assert restored["replay"]["size"] == 0 and restored["replay"]["cursor"] == 0
    same = buffer.create(96, (3,), (), block=8)
    target = {"replay": {k: getattr(same, k) for k in st["replay"]}, "env_steps": 0}
    restored, _ = ckpt.restore_latest(str(tmp_path), target)
    assert restored["replay"]["size"] == 88
    assert torch.equal(restored["replay"]["s1"], old.s1)


def test_ckpt_best_keeps_best_eval(tmp_path):
    """--ckpt-best keeps ckpt_best.pt and its sidecar at the best eval seen;
    --eval-only --ckpt-best restores it."""
    opts = _opts(tmp_path, 3, "--ckpt-best")
    ddpg.train(opts)
    best = tmp_path / "ckpt_best.pt"
    assert best.exists() and (tmp_path / "ckpt_best.pt.json").exists()
    side = json.loads((tmp_path / "ckpt_best.pt.json").read_text())
    assert side["step"] >= 1 and side["eval_ep_len"] > 0
    keeper = common.BestCkptKeeper(opts)
    assert keeper.best == side["eval_ep_len"]
    mtime = os.path.getmtime(best)
    keeper.update(99, side["eval_ep_len"] - 1.0, None)  # worse: no write
    assert os.path.getmtime(best) == mtime

    final = ddpg.train(_opts(tmp_path, 3, "--ckpt-best", "--eval-only"))
    assert 0.0 < final <= 10.0


def test_ckpt_best_meta_is_atomic_with_weights(tmp_path):
    """The improvement gate's step and eval live inside ckpt_best.pt: a
    lost sidecar must not reseed the gate to -inf and let a worse eval
    clobber better weights."""
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "step": 7}
    d = str(tmp_path)
    ckpt.save_best(d, step=42, eval_len=180.5, tree=tree)
    os.remove(os.path.join(d, "ckpt_best.pt.json"))

    assert ckpt.best_meta(d) == {"step": 42, "eval_ep_len": 180.5}
    restored, step = ckpt.restore_best(d, {"w": torch.zeros(2, 3), "step": 0})
    assert step == 42
    _equal(restored, tree)
    keeper = common.BestCkptKeeper(SimpleNamespace(ckpt_dir=d, ckpt_best=True))
    assert keeper.best == 180.5
    assert ckpt.best_meta(str(tmp_path / "nope")) is None

"""The port's data-parallel checkpoints (``utils/checkpoint.py``) on the CPU:
the helpers of ``tests/test_checkpoint.py:280-348`` (the rank-0 fallback of
``restore_latest``, ``latest_sharded_step`` over complete rank sets, the
global-to-rank slice), and on 2 gloo ranks the global file one launcher
writes (rows rank-major, replicated entries and the generator rank 0's,
every rank's generator beside them), its resume (each rank's state byte-equal
to the one saved, and the next segment byte-equal to the unbroken run's),
ranks that disagree on the step stopping the resume, and batch norm's
running statistics kept per rank, rank 0's in the file (as the JAX package
keeps chip 0's).

The ranks run module-level functions of this file (a spawned rank imports
it by name); nothing here imports JAX.
"""

import os
from types import SimpleNamespace

import torch

from cartpoleplusplus_tpu_torch import parallel
from cartpoleplusplus_tpu_torch.agents import common, ddpg
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig
from cartpoleplusplus_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

CFG = CartpoleConfig(discrete_actions=False, action_repeats=2, steps_per_repeat=2,
                     initial_force_steps=4, max_episode_len=20)
GLOBAL_ENVS, CAPACITY = 16, 256
SEG_KW = dict(gamma=0.99, tau=0.005, batch_size=8, warmup_steps=2, steps_per_segment=4,
              ou_theta=0.15, ou_sigma=0.2)


def _cpu(sd):
    if isinstance(sd, dict):
        return {k: _cpu(v) for k, v in sd.items()}
    if isinstance(sd, list):
        return [_cpu(v) for v in sd]
    return sd.detach().cpu().clone() if torch.is_tensor(sd) else sd


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return a == b


def _rank_state(mesh, use_batch_norm=False):
    """A DDPG state built for the whole job and placed on this rank, and its
    distributed segment."""
    opts = SimpleNamespace(seed=0, replay_capacity=CAPACITY, num_devices=mesh.world,
                           use_batch_norm=use_batch_norm)
    st = ddpg.init_state(opts, CFG, common.make_venv(CFG, GLOBAL_ENVS, device="cpu"),
                         hidden=(16, 16))
    segment, shard = parallel.make_distributed_segment(
        mesh, common.make_venv(CFG, GLOBAL_ENVS // mesh.world, device="cpu"), **SEG_KW)
    shard(st)
    return st, segment


# ---------------------------------------------------------------------------
# The ranks' work
# ---------------------------------------------------------------------------


def _save_then_continue(mesh, ckpt_dir: str) -> dict:
    """One segment, the global save one launcher makes, one more segment."""
    st, segment = _rank_state(mesh)
    segment(st)
    common.save_checkpoint(SimpleNamespace(ckpt_dir=ckpt_dir, ckpt_skip_replay=False,
                                           num_processes=1), 1, st, mesh, ddpg.SHARDED_FIELDS)
    saved = _cpu(st.state_dict())
    segment(st)
    return dict(saved=saved, after=_cpu(st.state_dict()))


def _resume_then_continue(mesh, ckpt_dir: str) -> dict:
    st, segment = _rank_state(mesh)
    st, step = ckpt.restore_latest_sharded(ckpt_dir, st, mesh)
    restored = _cpu(st.state_dict())
    segment(st)
    return dict(step=step, restored=restored, after=_cpu(st.state_dict()))


def _disagreeing_resume(mesh, root: str) -> str:
    st, _ = _rank_state(mesh)
    try:
        ckpt.restore_latest_sharded(os.path.join(root, f"dir{mesh.rank}"), st, mesh)
    except SystemExit as e:
        return str(e)
    return "restored"


def _batch_norm_run(mesh, ckpt_dir: str) -> dict:
    st, segment = _rank_state(mesh, use_batch_norm=True)
    before = _cpu(st.critic.state_dict())
    for _ in range(2):
        segment(st)
    common.save_checkpoint(SimpleNamespace(ckpt_dir=ckpt_dir, ckpt_skip_replay=True,
                                           num_processes=1), 2, st, mesh, ddpg.SHARDED_FIELDS)
    return dict(before=before, actor=_cpu(st.actor.state_dict()),
                critic=_cpu(st.critic.state_dict()))


# ---------------------------------------------------------------------------
# The helpers (tests/test_checkpoint.py:280-348)
# ---------------------------------------------------------------------------


def test_restore_latest_falls_back_to_rank0_file(tmp_path):
    """One process restores the replicated entries of the newest rank-0
    file; its rank-sized shard keeps the fresh value.  The newest step wins
    across both kinds of file."""
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    rank0 = {"params": params, "obs": torch.ones((4, 7))}  # a shard of a global 8
    for step, rank in ((2, 0), (2, 1), (5, 0)):  # step 5: rank 1 missing
        ckpt.save_rank(str(tmp_path), step, rank0, rank, 2)
    target = {"params": {"w": torch.zeros((2, 3))}, "obs": torch.zeros((8, 7))}
    restored, step = ckpt.restore_latest(str(tmp_path), target)
    assert step == 5
    assert torch.equal(restored["params"]["w"], params["w"])
    assert torch.equal(restored["obs"], torch.zeros((8, 7)))
    ckpt.save(str(tmp_path), 1, target)
    assert ckpt.restore_latest(str(tmp_path), target)[1] == 5
    ckpt.save(str(tmp_path), 9, target)
    assert ckpt.restore_latest(str(tmp_path), target)[1] == 9


def test_latest_sharded_step_requires_complete_rank_set(tmp_path):
    tree = {"x": torch.zeros(2)}
    for step, rank, world in ((2, 0, 2), (2, 1, 2), (7, 0, 2), (9, 0, 4)):
        ckpt.save_rank(str(tmp_path), step, tree, rank, world)
    assert ckpt.latest_sharded_step(str(tmp_path), 2) == 2
    assert ckpt.latest_sharded_step(str(tmp_path), 4) is None
    assert ckpt.latest_sharded_step(str(tmp_path / "nope"), 2) is None


def test_slice_global_to_local_per_rank():
    local = {"obs": torch.zeros((4, 7)), "params": {"w": torch.zeros((2, 3))},
             "scalar": torch.zeros((), dtype=torch.int32)}
    glob = {"obs": torch.arange(56.0).reshape(8, 7), "params": {"w": torch.ones((2, 3))},
            "scalar": torch.tensor(9, dtype=torch.int32), "rank_generators": [1, 2]}
    for rank in (0, 1):
        out = ckpt._slice_global_to_local(local, glob, rank, 2)
        assert torch.equal(out["obs"], glob["obs"][rank * 4:(rank + 1) * 4])
        assert torch.equal(out["params"]["w"], glob["params"]["w"])
        assert int(out["scalar"]) == 9 and out["rank_generators"] == [1, 2]
    odd = ckpt._slice_global_to_local({"obs": torch.zeros((4, 7))},
                                      {"obs": torch.zeros((5, 7))}, 0, 2)
    assert odd["obs"].shape == (5, 7)


# ---------------------------------------------------------------------------
# On ranks
# ---------------------------------------------------------------------------


def test_global_file_layout_and_exact_resume(tmp_path):
    d = str(tmp_path)
    first = parallel.run_ranks(2, _save_then_continue, d, timeout_s=240)
    assert os.listdir(d) == ["ckpt_1.pt"]
    raw = ckpt.load_raw(d, 1)
    saved = [r["saved"] for r in first]
    for key in ("obs", "ou_noise"):
        assert torch.equal(raw[key], torch.cat([s[key] for s in saved])), key
    for key in ("s1", "action", "reward", "terminal"):
        assert torch.equal(raw["replay"][key], torch.cat([s["replay"][key] for s in saved]))
    assert torch.equal(raw["env_states"]["pos"],
                       torch.cat([s["env_states"]["pos"] for s in saved]))
    assert _same(raw["actor"], saved[0]["actor"]) and _same(raw["actor"], saved[1]["actor"])
    assert torch.equal(raw["generator"], saved[0]["generator"])
    assert _same(raw["rank_generators"], [s["generator"] for s in saved])
    assert not torch.equal(saved[0]["generator"], saved[1]["generator"])

    second = parallel.run_ranks(2, _resume_then_continue, d, timeout_s=240)
    for a, b in zip(first, second):
        assert b["step"] == 1
        assert _same(b["restored"], a["saved"])
        assert _same(b["after"], a["after"])


def test_ranks_disagreeing_on_the_step_stop(tmp_path):
    tree = {"x": torch.zeros(2)}
    ckpt.save(str(tmp_path / "dir0"), 3, tree)
    ckpt.save(str(tmp_path / "dir1"), 4, tree)
    out = parallel.run_ranks(2, _disagreeing_resume, str(tmp_path), timeout_s=240)
    assert all("ranks disagree on the newest restorable step ([3, 4])" in m for m in out)


def test_batch_norm_statistics_stay_per_rank(tmp_path):
    """--use-batch-norm on 2 ranks: the parameters stay byte-equal, each
    rank's running statistics follow its own batches, and the global file
    (skip-replay) holds rank 0's, as the JAX package saves chip 0's copy."""
    a, b = parallel.run_ranks(2, _batch_norm_run, str(tmp_path), timeout_s=240)
    stats = [k for k in a["critic"] if k.endswith((".mean", ".var"))]
    assert stats, sorted(a["critic"])
    params = [k for k in a["critic"] if k not in stats]
    for k in params:
        assert torch.equal(a["critic"][k], b["critic"][k]), k
    assert any(not torch.equal(a["critic"][k], a["before"][k]) for k in stats)
    assert any(not torch.equal(a["critic"][k], b["critic"][k]) for k in stats)
    raw = ckpt.load_raw(str(tmp_path), 2)
    assert _same(raw["critic"], a["critic"]) and _same(raw["actor"], a["actor"])
    assert raw["replay"]["size"] == 0

"""The port's data-parallel programs through their CLIs on the CPU, on gloo
ranks: the counterpart of ``tests/test_multihost_cli.py`` and of
``tests/test_parallel.py``'s ``--num-devices`` CLI tests.

- every agent's ``main`` with ``--num-devices 2`` (JAX's ``_MP_EXTRA``
  flags): one launcher, two spawned ranks, rank 0's eval returned;
- two launchers (``--num-processes 2 --num-devices 2 --coordinator``), each
  a ``python -m`` process running its one rank: one metrics writer; a
  save, a kill (the job exits) and a resume on rank files, then
  ``--eval-only`` in one process from the rank-0 file; a resume from one
  process's global file; ``--eval-only`` refused;
- two launchers of two local ranks each (``--num-devices 4``);
- SAC with two launchers.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from cartpoleplusplus_tpu_torch.agents import ddpg, dqn, lrpg, naf, ppo, sac
from cartpoleplusplus_tpu_torch.parallel import distributed
from cartpoleplusplus_tpu_torch.parallel.mesh import free_port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = "240"
# tests/test_multihost_cli.py's sizes.
BASE = ["--num-envs", "8", "--num-eval", "4", "--action-repeats", "2", "--steps-per-repeat", "2",
        "--max-episode-len", "10", "--eval-freq", "1", "--seed", "0", "--device", "cpu"]
OFF_POLICY = ["--steps-per-segment", "3", "--batch-size", "8", "--replay-capacity", "128",
              "--warmup-steps", "1"]
EXTRA = {"ddpg": OFF_POLICY, "sac": OFF_POLICY, "dqn": OFF_POLICY, "naf": OFF_POLICY,
         "lrpg": [], "ppo": ["--rollout-steps", "4", "--ppo-minibatches", "2", "--ppo-epochs", "2"]}
AGENTS = {"ddpg": ddpg, "sac": sac, "dqn": dqn, "naf": naf, "lrpg": lrpg, "ppo": ppo}


def _same(a, b) -> bool:
    """Nested state dicts equal key for key, tensors byte for byte."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    return a == b


def _rows(path) -> list:
    return [json.loads(line) for line in open(path)]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env[distributed.RANK_TIMEOUT_ENV] = RANK_TIMEOUT_S
    env["OMP_NUM_THREADS"] = "1"  # the launchers share the test worker's cores
    return env


def _pair(agent: str, devices: int, extra_by_rank: dict, batches: int = 2) -> list:
    """Two launchers of ``python -m ...agents.<agent>``, process ids 0 and
    1 → their outputs; both must exit 0."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"cartpoleplusplus_tpu_torch.agents.{agent}", *BASE,
         *EXTRA[agent], "--num-train-batches", str(batches), "--num-devices", str(devices),
         "--num-processes", "2", "--process-id", str(pid), "--coordinator", f"localhost:{port}",
         *extra_by_rank.get(pid, ())],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    outs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"launcher failed:\n{out[-3000:]}"
    return outs


def _starts(outs: list) -> list:
    """The ranks' start lines (rank, world, backend) from launchers' output."""
    return sorted((r["rank"], r["world"], r["backend"]) for out in outs for line in out.splitlines()
                  if line.startswith("PARALLEL ") and (r := json.loads(line[9:]))["event"] == "start")


@pytest.mark.parametrize("agent", sorted(AGENTS))
def test_agent_cli_num_devices_2(agent, tmp_path, monkeypatch):
    """``main`` with --num-devices 2: two spawned gloo ranks train, rank 0
    writes the metrics (env steps counted over both shards) and its final
    eval is what ``main`` returns; each rank reports itself."""
    monkeypatch.setenv(distributed.RANK_TIMEOUT_ENV, RANK_TIMEOUT_S)
    jsonl = tmp_path / "m.jsonl"
    final = AGENTS[agent].main([*BASE, *EXTRA[agent], "--num-train-batches", "2",
                                "--num-devices", "2", "--metrics-jsonl", str(jsonl)])
    trains = [r for r in _rows(jsonl) if r["event"] == "train"]
    assert len(trains) == 2 and 0.0 < final <= 10.0 and final == trains[-1]["eval_ep_len"]
    if agent in ("ddpg", "sac", "dqn", "naf"):
        assert [r["env_steps"] for r in trains] == [3 * 8, 6 * 8]
    if agent == "ppo":
        assert [r["env_steps"] for r in trains] == [4 * 8, 8 * 8]
    reports = distributed.LAST_REPORTS
    assert [(r["rank"], r["world"], r["backend"]) for r in reports] == [(0, 2, "gloo"),
                                                                       (1, 2, "gloo")]
    assert all(r["result"] == final for r in reports)
    assert all(len(r["segment_s"]) == 2 for r in reports)


def test_two_launchers_ddpg_save_kill_resume(tmp_path):
    """Two launchers: rank 0 alone writes metrics; both ranks write their
    ckpt_2 rank file (params and optimizers byte-equal, env shards apart);
    a relaunch to 4 restores at 2 and trains segments 3 and 4 only; one
    process's --eval-only then restores the rank-0 file."""
    ck, m0, m1 = tmp_path / "ck", tmp_path / "m0.jsonl", tmp_path / "m1.jsonl"
    common = ("--ckpt-dir", str(ck), "--ckpt-freq", "2")
    outs = _pair("ddpg", 2, {0: (*common, "--metrics-jsonl", str(m0)),
                             1: (*common, "--metrics-jsonl", str(m1))})
    assert _starts(outs) == [(0, 2, "gloo"), (1, 2, "gloo")]
    assert m0.exists() and not m1.exists()
    assert [r["segment"] for r in _rows(m0) if r["event"] == "train"] == [1, 2]
    assert sorted(os.listdir(ck)) == ["ckpt_2.rank0of2.pt", "ckpt_2.rank1of2.pt"]
    files = [torch.load(ck / f"ckpt_2.rank{k}of2.pt", weights_only=True) for k in (0, 1)]
    for net in ("actor", "critic", "actor_opt", "critic_opt"):
        assert _same(files[0][net], files[1][net]), net
    assert not torch.equal(files[0]["env_states"]["pos"], files[1]["env_states"]["pos"])
    assert files[0]["replay"]["s1"].shape[0] == 64  # a shard of 128

    m2 = tmp_path / "m_resume.jsonl"
    _pair("ddpg", 2, {0: (*common, "--metrics-jsonl", str(m2)), 1: common}, batches=4)
    rows = _rows(m2)
    assert [r["step"] for r in rows if r["event"] == "restore"] == [2]
    assert [r["segment"] for r in rows if r["event"] == "train"] == [3, 4]
    assert {"ckpt_4.rank0of2.pt", "ckpt_4.rank1of2.pt"} <= set(os.listdir(ck))

    ev = tmp_path / "eval.jsonl"
    final = ddpg.main([*BASE, *OFF_POLICY, "--ckpt-dir", str(ck), "--eval-only",
                       "--metrics-jsonl", str(ev)])
    evals = [r for r in _rows(ev) if r["event"] == "eval_only"]
    assert evals[0]["segment"] == 4 and 0.0 < evals[0]["eval_ep_len"] == final <= 10.0


def test_single_process_file_resumes_on_two_launchers(tmp_path):
    """A one-process run's global ckpt_2.pt resumes on two launchers: each
    rank takes its rows, and segments 3 and 4 are trained."""
    ck = tmp_path / "ck"
    common = ("--ckpt-dir", str(ck), "--ckpt-freq", "2")
    ddpg.main([*BASE, *OFF_POLICY, "--num-train-batches", "2", *common])
    assert (ck / "ckpt_2.pt").exists()
    m = tmp_path / "m.jsonl"
    _pair("ddpg", 2, {0: (*common, "--metrics-jsonl", str(m)), 1: common}, batches=4)
    rows = _rows(m)
    assert [r["step"] for r in rows if r["event"] == "restore"] == [2]
    assert [r["segment"] for r in rows if r["event"] == "train"] == [3, 4]


def test_two_launchers_refuse_eval_only(tmp_path):
    opts = ddpg.make_parser().parse_args(
        [*BASE, "--num-processes", "2", "--num-devices", "2", "--coordinator", "localhost:1",
         "--eval-only", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--eval-only needs no mesh"):
        ddpg.train(opts)


def test_two_launchers_of_two_ranks(tmp_path):
    """--num-devices 4 over two launchers: each spawns its two local ranks,
    global ranks 0-3, and rank 0 alone writes the metrics."""
    m = tmp_path / "m.jsonl"
    outs = _pair("ddpg", 4, {0: ("--metrics-jsonl", str(m))})
    assert _starts(outs) == [(r, 4, "gloo") for r in range(4)]
    trains = [r for r in _rows(m) if r["event"] == "train"]
    assert [r["env_steps"] for r in trains] == [3 * 8, 6 * 8]
    assert all(0.0 < r["eval_ep_len"] <= 10.0 for r in trains)


def test_two_launchers_sac(tmp_path):
    m = tmp_path / "sac.jsonl"
    _pair("sac", 2, {0: ("--metrics-jsonl", str(m))})
    trains = [r for r in _rows(m) if r["event"] == "train"]
    assert len(trains) == 2 and all(0.0 < r["eval_ep_len"] <= 10.0 for r in trains)

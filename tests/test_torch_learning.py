"""The port's DDPG program on the CPU: its ``train`` beside the JAX
``train`` on the same argv (the same events, field sets, segments and
env-step counts in the metrics jsonl), and the counterparts of the JAX
``tests/test_learning.py::test_ddpg_improves`` and ``test_naf_improves``:
a short budget of updates improves the greedy policy on a fixed seed.

Whole runs are compared by outcome, never by curve: same-seed runs of the
two frameworks diverge chaotically after a few segments (BASELINE.md r5).
"""

import json
import shlex

import torch

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import ddpg as jddpg
from cartpoleplusplus_tpu_torch.agents import ddpg, naf

torch.set_num_threads(2)

TOY = """--num-train-batches 2 --num-envs 4 --num-eval 4 --action-repeats 2
  --steps-per-repeat 2 --max-episode-len 10 --steps-per-segment 3 --batch-size 8
  --replay-capacity 64 --warmup-steps 1 --eval-freq 1 --ckpt-freq 1"""
# tests/test_learning.py's shared smoke flags: 32 envs, 60-step episodes.
_SMOKE = [
    "--num-envs", "32", "--num-eval", "32",
    "--action-repeats", "2", "--steps-per-repeat", "3",
    "--max-episode-len", "60", "--eval-freq", "20",
    "--steps-per-segment", "25", "--batch-size", "64",
    "--replay-capacity", "4096", "--warmup-steps", "10", "--seed", "0",
]


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_logs_what_jax_logs(tmp_path):
    """Both trains on one argv: the same event names in order, each with
    the same fields, and equal ``segment`` and ``env_steps`` values; both
    return the last eval's episode length."""
    argv = shlex.split(TOY)
    jparser = jcommon.make_parser("t")
    jddpg.add_ddpg_opts(jparser)
    jopts = jparser.parse_args(argv + ["--metrics-jsonl", str(tmp_path / "jax.jsonl"),
                                       "--ckpt-dir", str(tmp_path / "jax")])
    jfinal = jddpg.train(jopts)
    final = ddpg.main(argv + ["--device", "cpu", "--metrics-jsonl", str(tmp_path / "port.jsonl"),
                              "--ckpt-dir", str(tmp_path / "port")])
    want, got = _events(tmp_path / "jax.jsonl"), _events(tmp_path / "port.jsonl")
    assert [e["event"] for e in got] == [e["event"] for e in want] == ["train", "train"]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert (g["segment"], g["env_steps"]) == (w["segment"], w["env_steps"])
    assert [e["env_steps"] for e in got] == [12, 24]
    assert 0.0 < final <= 10.0 and 0.0 < jfinal <= 10.0
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["ckpt_1.pt", "ckpt_2.pt"]


def test_ddpg_improves(tmp_path):
    """The port's counterpart of the JAX test_ddpg_improves, same flags.
    An untrained policy evals at ~7-8 steps on this 60-step horizon; the
    port's seed 0 reads 20.06, 24.53 and 16.56 at segments 20, 40 and 60
    (the JAX package's 27.4 at 60: the two curves are not compared).  Gate:
    the final eval above 12.0, the JAX test's own gate, 27 % under the
    port's result."""
    final = ddpg.main(["--device", "cpu", "--num-train-batches", "60", "--reward-scale", "0.1",
                       "--grad-clip", "10.0", *_SMOKE,
                       "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    lens = [e["eval_ep_len"] for e in _events(tmp_path / "m.jsonl")]
    assert len(lens) == 3 and lens[-1] == final
    assert final > 12.0, f"DDPG did not learn: eval len {final}"


def test_naf_improves(tmp_path):
    """The port's counterpart of the JAX test_naf_improves, same flags and
    gate: the final eval above 12.0, where an untrained policy evals at ~7-8
    steps on this 60-step horizon.  The port's seed 0 reads 21.78, 22.66
    and 21.84 at segments 20, 40 and 60."""
    final = naf.main(["--device", "cpu", "--num-train-batches", "60", "--reward-scale", "0.1",
                      "--grad-clip", "10.0", *_SMOKE,
                      "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    lens = [e["eval_ep_len"] for e in _events(tmp_path / "m.jsonl")]
    print(f"NAF evals at segments 20, 40, 60: {lens}")
    assert len(lens) == 3 and lens[-1] == final
    assert final > 12.0, f"NAF did not learn: eval len {final}"

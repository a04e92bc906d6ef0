"""The TensorBoard half of the port's ``utils/metrics.MetricsLogger``
(``--tb-dir``) against the JAX package's logger: the same ``log`` calls
write the same scalars (tags, steps, values), read back with tensorboard's
event reader; the jsonl sink is unchanged beside it; where tensorboard
cannot be imported the logger warns on one line and goes on; and the
on-policy CLIs write their ``train`` events' numbers as scalars."""

import json
import shlex
import sys

import pytest

from cartpoleplusplus_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from cartpoleplusplus_tpu_torch.agents import lrpg, ppo
from cartpoleplusplus_tpu_torch.utils.metrics import MetricsLogger

pytest.importorskip("tensorboard")

CALLS = [
    ("train", dict(segment=1, env_steps=64, loss=0.5, done=True, note="text")),
    ("train", dict(segment=2, env_steps=128, loss=0.25, done=False, note="text")),
    ("restore", dict(step=7)),
    ("eval_only", dict(segment=4, eval_ep_len=12.5, eval_ep_rew=11.0)),
    ("summary", dict(mean_len=3.5, episodes=2)),          # no step: the event count
    ("episode", dict(step="first", total_reward=1.5)),    # a label step: the count
    ("event_log", dict(episodes=3, lengths=[1, 2, 3])),
]


def scalars(logdir) -> dict:
    """{tag: [(step, value), ...]} of every scalar under ``logdir``."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def _write(logger_cls, tmp_path, name):
    log = logger_cls(str(tmp_path / f"{name}.jsonl"), quiet=True, tb_dir=str(tmp_path / name))
    for event, fields in CALLS:
        log.log(event, **fields)
    log.close()
    with open(tmp_path / f"{name}.jsonl") as f:
        return scalars(tmp_path / name), [json.loads(line) for line in f]


def test_scalars_equal_jax(tmp_path):
    got, got_lines = _write(MetricsLogger, tmp_path, "port")
    want, want_lines = _write(JMetricsLogger, tmp_path, "jax")
    assert got == want
    assert got == {
        "train/env_steps": [(1, 64.0), (2, 128.0)],
        "train/loss": [(1, 0.5), (2, 0.25)],
        "restore/step": [(7, 7.0)],
        "eval_only/eval_ep_len": [(4, 12.5)],
        "eval_only/eval_ep_rew": [(4, 11.0)],
        "summary/mean_len": [(5, 3.5)],
        "summary/episodes": [(5, 2.0)],
        "episode/total_reward": [(6, 1.5)],
        "event_log/episodes": [(7, 3.0)],
    }
    strip = lambda lines: [{k: v for k, v in r.items() if k not in ("ts", "elapsed_s")}
                           for r in lines]
    assert strip(got_lines) == strip(want_lines) == [
        {"event": e, **f} for e, f in CALLS]


def test_without_tensorboard_warns_and_goes_on(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = MetricsLogger(str(tmp_path / "m.jsonl"), tb_dir=str(tmp_path / "tb"))
    log.log("train", segment=1, loss=0.5)
    log.close()
    err = capsys.readouterr().err
    assert err.count("[metrics] tensorboard unavailable") == 1
    assert "continuing with JSONL/stderr only" in err and "train segment=1 loss=0.5" in err
    assert not (tmp_path / "tb").exists()
    assert json.loads((tmp_path / "m.jsonl").read_text())["loss"] == 0.5


TOY = """--num-train-batches 2 --num-envs 4 --num-eval 4 --eval-freq 1 --action-repeats 2
  --steps-per-repeat 2 --max-episode-len 5 --hidden 16 8"""


@pytest.mark.parametrize("agent,extra", [(ppo, "--rollout-steps 4 --ppo-minibatches 2"),
                                         (lrpg, "")], ids=["ppo", "lrpg"])
def test_on_policy_cli_tb_dir(agent, extra, tmp_path):
    """``--tb-dir``: each ``train`` event's numbers at its ``update``."""
    agent.main(shlex.split(f"{TOY} {extra}") + [
        "--device", "cpu", "--metrics-jsonl", str(tmp_path / "m.jsonl"),
        "--tb-dir", str(tmp_path / "tb")])
    got = scalars(tmp_path / "tb")
    trains = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    trains = [t for t in trains if t["event"] == "train"]
    assert len(trains) == 2
    for key in ("eval_ep_len", "eval_ep_rew", "loss"):
        assert got[f"train/{key}"] == [(t["update"], pytest.approx(t[key], rel=1e-6))
                                       for t in trains]
    assert got["train/update"] == [(1, 1.0), (2, 2.0)]

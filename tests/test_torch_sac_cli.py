"""The port's SAC program on the CPU: its CLI against the JAX package's
(the same flags, defaults and choices for the recipes' argv, the same
``CartpoleConfig``; unported flags refused at startup), its ``train``
beside the JAX ``train`` on one toy argv (the same events, fields,
segments and env steps), the learning script's log against ``train``'s,
and the counterparts of ``tests/test_learning.py::test_sac_improves`` and
``test_sac_alpha_floor_clamps``.

Whole runs are compared by outcome, never by curve: same-seed runs of the
two frameworks diverge chaotically after a few segments (BASELINE.md r5).
"""

import dataclasses
import json
import os
import shlex
import subprocess
import sys

import pytest
import torch

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import sac as jsac
from cartpoleplusplus_tpu.env.config import config_from_opts as jconfig_from_opts
from cartpoleplusplus_tpu_torch.agents import sac
from cartpoleplusplus_tpu_torch.env.config import config_from_opts

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scripts/chip_queue6.sh's pixel recipe (sac_pixels_fix) and low-dim one
# (sac_lowdim_fix), and tests/test_learning.py's smoke flags.
PIXELS = """--use-raw-pixels --num-cameras 2 --obs-pool 2 --pixel-encoder conv
  --num-envs 512 --num-eval 64 --eval-freq 500
  --steps-per-segment 25 --batch-size 256 --replay-capacity 65536
  --warmup-steps 40 --num-train-batches 15000
  --actor-learning-rate 1e-4 --critic-learning-rate 3e-4 --lr-schedule cosine
  --reward-scale 0.1 --grad-clip 10 --aug-shift 2 --alpha-min 0.02 --pallas-render
  --ckpt-dir runs/ckpt_sac_pixels_s0 --ckpt-freq 5000 --ckpt-skip-replay
  --seed 0 --metrics-jsonl runs/sac_pixels_fix_s0.jsonl"""
LOWDIM = """--num-envs 128 --num-eval 64 --eval-freq 100
  --steps-per-segment 25 --batch-size 256 --replay-capacity 131072
  --warmup-steps 40 --num-train-batches 5000
  --reward-scale 0.1 --grad-clip 10 --lr-schedule cosine
  --alpha-min 0.02 --seed 0 --metrics-jsonl runs/sac_lowdim_fix_s0.jsonl"""
_SMOKE = """--num-envs 32 --num-eval 32 --action-repeats 2 --steps-per-repeat 3
  --max-episode-len 60 --eval-freq 20 --steps-per-segment 25 --batch-size 64
  --replay-capacity 4096 --warmup-steps 10 --seed 0"""
ARGVS = {"pixels": PIXELS, "lowdim": LOWDIM, "smoke": _SMOKE, "defaults": "",
         "every_sac_flag": """--alpha-learning-rate 1e-3 --init-alpha 0.3
           --target-entropy -1.5 --alpha-min 0.01 --tau 0.01 --num-devices 1
           --obs-samples 2 --hidden 64 32 --pixel-pool 2 --ckpt-best --eval-only"""}
TOY = """--num-train-batches 2 --num-envs 4 --num-eval 4 --action-repeats 2
  --steps-per-repeat 2 --max-episode-len 10 --steps-per-segment 3 --batch-size 8
  --replay-capacity 64 --warmup-steps 1 --eval-freq 1"""


def _jax_parser():
    parser = jcommon.make_parser("t")
    jsac.add_sac_opts(parser)
    return parser


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parser_matches_jax(name):
    argv = shlex.split(ARGVS[name])
    want = vars(_jax_parser().parse_args(argv))
    got = vars(sac.make_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want


def test_parser_choices_match_jax():
    def choices(parser):
        return {a.dest: (a.option_strings, a.choices, a.nargs, a.type, a.default)
                for a in parser._actions if a.dest not in ("help", "device")}

    assert choices(sac.make_parser()) == choices(_jax_parser())
    for argv in (["--pixel-encoder", "mlp"], ["--lr-schedule", "linear"], ["--per"]):
        with pytest.raises(SystemExit):
            sac.make_parser().parse_args(argv)


@pytest.mark.parametrize("name", ["pixels", "lowdim"])
def test_config_from_opts_matches_jax(name):
    argv = shlex.split(ARGVS[name])
    want = jconfig_from_opts(_jax_parser().parse_args(argv), discrete_actions=False)
    got = config_from_opts(sac.make_parser().parse_args(argv), discrete_actions=False)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name


# flag argv → what its refusal must say (the JAX contract's words, and the
# port's rank count per launcher)
REFUSED = {
    "--num-processes 2 --num-devices 2": r"--num-processes > 1 needs --coordinator host:port",
    "--num-processes 3 --num-devices 4 --coordinator h:1":
        r"--num-devices must be a multiple of --num-processes",
}


@pytest.mark.parametrize("flags", sorted(REFUSED))
def test_unported_flag_stops_at_startup(flags, tmp_path):
    """The JAX package's multi-process contract (and the divisibility its
    multi-device CLI branch demands): each refused before anything is built
    or written, on the CPU as on the card."""
    opts = sac.make_parser().parse_args(
        shlex.split(flags) + ["--device", "cpu", "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    with pytest.raises(SystemExit, match=REFUSED[flags]):
        sac.train(opts)
    assert not (tmp_path / "m.jsonl").exists()


PORTED = ("--export-policy", "--tb-dir")


@pytest.mark.parametrize("flag", PORTED)
def test_ported_flag_runs(flag, tmp_path):
    """``--export-policy`` and ``--tb-dir``, refused at startup until their
    ROADMAP items were ported, run on the CPU: the artifact loads and acts
    on float32 low-dim observations, and the logdir holds each
    ``train`` event's ``eval_ep_len`` at its segment."""
    out, jsonl = str(tmp_path / "out"), tmp_path / "m.jsonl"
    sac.main(shlex.split(TOY) + ["--device", "cpu", "--metrics-jsonl", str(jsonl), flag, out])
    events = [json.loads(line) for line in jsonl.read_text().splitlines()]
    if flag == "--export-policy":
        from cartpoleplusplus_tpu_torch.utils import export

        act = export.load_policy(out, "cpu")(torch.zeros((3, 2, 2, 7)))
        assert act.shape == (3, 2) and bool((act.abs() <= 1.0).all())
        assert events[-1]["event"] == "export_policy" and events[-1]["bytes"] > 0
    else:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(out)
        acc.Reload()
        assert [(e.step, e.value) for e in acc.Scalars("train/eval_ep_len")] == [
            (e["segment"], e["eval_ep_len"]) for e in events if e["event"] == "train"]


def test_train_refuses_cpu_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sac.main(["--num-envs", "4"])
    with pytest.raises(SystemExit, match="--eval-only needs --ckpt-dir"):
        sac.main(["--device", "cpu", "--eval-only", "--ckpt-dir", str(tmp_path),
                  "--num-envs", "4", "--num-eval", "4", "--max-episode-len", "3"])


def test_train_logs_what_jax_logs(tmp_path):
    """Both trains on one argv: the same events in order, each with the
    same fields, and equal ``segment`` and ``env_steps``; the learning
    script logs what ``train`` logs, between its header and summary."""
    argv = shlex.split(TOY)
    jfinal = jsac.train(_jax_parser().parse_args(
        argv + ["--metrics-jsonl", str(tmp_path / "jax.jsonl"), "--ckpt-dir", str(tmp_path / "j")]))
    final = sac.main(argv + ["--device", "cpu", "--metrics-jsonl", str(tmp_path / "port.jsonl"),
                             "--ckpt-dir", str(tmp_path / "port")])
    want, got = _events(tmp_path / "jax.jsonl"), _events(tmp_path / "port.jsonl")
    assert [e["event"] for e in got] == [e["event"] for e in want] == ["train", "train"]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert (g["segment"], g["env_steps"]) == (w["segment"], w["env_steps"])
        assert g["alpha"] > 0.0 and g["entropy"] == g["entropy"]
    assert [e["env_steps"] for e in got] == [12, 24]
    assert 0.0 < final <= 10.0 and 0.0 < jfinal <= 10.0
    jax_files = sorted(p.name.replace(".msgpack", ".pt") for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == jax_files == ["ckpt_2.pt"]

    out = tmp_path / "script.jsonl"
    script = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_sac_lowdim.py"), "--segments", "2",
         "--out", str(out), "--", "--device", "cpu", *argv],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert script.returncode == 0, script.stderr
    logged = _events(out)
    assert [e["event"] for e in logged] == ["header", "train", "train", "summary"]
    for g, w in zip(logged[1:3], got):
        assert list(g) == list(w)
        assert (g["segment"], g["env_steps"]) == (w["segment"], w["env_steps"])
    assert logged[0]["argv"][-len(argv):] == argv and logged[0]["segments"] == 2
    summary = logged[-1]
    assert summary["best_eval"] == max(e["eval_ep_len"] for e in logged[1:3])
    assert summary["env_steps"] == 24 and summary["reached_gate"] is False


def test_script_stops_at_segments_of_a_longer_schedule(tmp_path):
    """``stop_at`` ends the run early while the cosine schedule keeps the
    length of --num-train-batches: the learning rate after 2 segments of
    a 4-segment schedule is the schedule's, not its end's."""
    argv = shlex.split(TOY.replace("--num-train-batches 2", "--num-train-batches 4")) + [
        "--device", "cpu", "--lr-schedule", "cosine", "--ckpt-dir", str(tmp_path)]
    sac.main(argv, stop_at=2)
    raw = torch.load(tmp_path / "ckpt_2.pt", weights_only=True)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_2.pt"]
    lr = raw["actor_opt"]["param_groups"][0]["lr"]
    opts = sac.make_parser().parse_args(argv)
    from cartpoleplusplus_tpu_torch.agents.common import make_lr

    updates = raw["actor_sched"]["last_epoch"]
    assert lr == pytest.approx(make_lr(opts, 3e-4)(updates), rel=1e-12)
    assert lr > make_lr(opts, 3e-4)(4 * 3)


def test_sac_improves(tmp_path):
    """The port's counterpart of the JAX test_sac_improves, same flags and
    gate (an untrained policy evals at ~7-8 steps on this 60-step horizon;
    the JAX package's calibrated seed-0 result is 17.1 at segment 60)."""
    final = sac.main(["--device", "cpu", "--num-train-batches", "60", "--reward-scale", "0.1",
                      "--grad-clip", "10.0", *shlex.split(_SMOKE),
                      "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    lens = [e["eval_ep_len"] for e in _events(tmp_path / "m.jsonl")]
    print(f"SAC smoke evals: {lens}")
    assert len(lens) == 3 and lens[-1] == final
    assert final > 12.0, f"SAC did not learn: eval len {final}"

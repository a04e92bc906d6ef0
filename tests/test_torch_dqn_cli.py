"""The port's DQN program on the CPU: its CLI against the JAX package's (the
same flags, defaults and choices, the same ``CartpoleConfig``; the ε
defaults and the ``--noisy`` backfill with JAX's notes; JAX's n-step
capacity stops; unported flags refused by name at startup), its ``train``
beside the JAX ``train`` on one toy Rainbow argv (the same events, fields in
JAX's order, segments and env steps) with the learning script's log,
checkpoints (a resume that ends byte for byte where the unbroken run ends,
``--ckpt-skip-replay``), and ``--eval-only`` (``--ckpt-best``) equal to a
fresh eval of the saved network.

Whole runs are compared by outcome, never by curve: same-seed runs of the
two frameworks diverge chaotically after a few segments (BASELINE.md r5).
"""

import dataclasses
import json
import os
import shlex
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import dqn as jdqn
from cartpoleplusplus_tpu.env.config import config_from_opts as jconfig_from_opts
from cartpoleplusplus_tpu_torch.agents import dqn
from cartpoleplusplus_tpu_torch.agents.common import eval_rollout, make_venv
from cartpoleplusplus_tpu_torch.env.config import config_from_opts
from cartpoleplusplus_tpu_torch.models.networks import QNetwork
from cartpoleplusplus_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scripts/chip_queue6.sh's full Rainbow recipe, tests/test_learning.py's DQN
# smoke flags, and the double-Q ablation of runs/dqn_double_s0.jsonl's kind.
RAINBOW = """--num-envs 128 --num-eval 64 --eval-freq 500
  --steps-per-segment 25 --batch-size 256 --replay-capacity 131072
  --warmup-steps 40 --num-train-batches 50000
  --lr-schedule cosine --reward-scale 0.1 --grad-clip 10
  --per --n-step 3 --dueling --c51 51 --c51-vmax 10 --noisy
  --ckpt-dir runs/ckpt_dqn_rainbow --ckpt-freq 5000 --ckpt-skip-replay
  --seed 0 --metrics-jsonl runs/dqn_rainbow_s0.jsonl"""
_SMOKE = """--num-train-batches 160 --eps-decay-steps 1000 --num-envs 32 --num-eval 32
  --action-repeats 2 --steps-per-repeat 3 --max-episode-len 60 --eval-freq 20
  --steps-per-segment 25 --batch-size 64 --replay-capacity 4096 --warmup-steps 10 --seed 0"""
ARGVS = {"rainbow": RAINBOW, "smoke": _SMOKE, "defaults": "",
         "no_double_q": "--no-double-q --eps-start 0.5 --eps-decay-steps 100",
         "pixels": "--use-raw-pixels --num-cameras 2 --obs-pool 2 --pixel-encoder conv --noisy",
         "every_dqn_flag": """--grad-clip 5 --reward-scale 0.1 --tau 0.02 --batch-size 64
           --replay-capacity 4096 --warmup-steps 5 --steps-per-segment 10 --eps-start 0.9
           --eps-end 0.1 --eps-decay-steps 100 --per --per-alpha 0.5 --per-beta0 0.3
           --per-eps 0.02 --n-step 2 --dueling --c51 21 --c51-vmin -1 --c51-vmax 5 --noisy
           --num-devices 1 --lr-schedule cosine --double-q --ckpt-best --eval-only"""}
TOY = """--num-train-batches 2 --num-envs 4 --num-eval 4 --action-repeats 2
  --steps-per-repeat 2 --max-episode-len 10 --steps-per-segment 5 --batch-size 8
  --replay-capacity 64 --warmup-steps 1 --eval-freq 1
  --per --n-step 3 --dueling --c51 51 --c51-vmax 10 --noisy --reward-scale 0.1
  --grad-clip 10 --lr-schedule cosine"""
FIELDS = ["ts", "elapsed_s", "event", "segment", "env_steps", "loss", "eps", "mean_reward",
          "eval_ep_len", "eval_ep_rew"]


def _jax_parser():
    parser = jcommon.make_parser("t")
    jdqn.add_dqn_opts(parser)
    return parser


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parser_matches_jax(name):
    argv = shlex.split(ARGVS[name])
    want = vars(_jax_parser().parse_args(argv))
    got = vars(dqn.make_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want


def test_parser_choices_match_jax():
    def choices(parser):
        return {a.dest: (a.option_strings, a.choices, a.nargs, a.type, a.default)
                for a in parser._actions if a.dest not in ("help", "device")}

    assert choices(dqn.make_parser()) == choices(_jax_parser())
    assert dqn.make_parser().parse_args([]).double_q is True
    assert dqn.make_parser().parse_args(["--no-double-q"]).double_q is False
    for argv in (["--pixel-encoder", "mlp"], ["--lr-schedule", "linear"], ["--c51", "x"]):
        with pytest.raises(SystemExit):
            dqn.make_parser().parse_args(argv)


@pytest.mark.parametrize("name", ["rainbow", "pixels"])
def test_config_from_opts_matches_jax(name):
    argv = shlex.split(ARGVS[name])
    want = jconfig_from_opts(_jax_parser().parse_args(argv), discrete_actions=True)
    got = config_from_opts(dqn.make_parser().parse_args(argv), discrete_actions=True)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name


# flag argv → what its refusal must say (the JAX CLIs' words)
REFUSED = {
    "--num-processes 2 --num-devices 2 --coordinator h:1 --eval-only":
        r"--eval-only needs no mesh: run it single-process",
    "--num-devices 3": r"--num-envs and --replay-capacity must be divisible by --num-devices",
}


@pytest.mark.parametrize("flags", sorted(REFUSED))
def test_unported_flag_stops_at_startup(flags, tmp_path):
    """The JAX package's multi-process contract (and the divisibility its
    multi-device CLI branch demands): each refused before anything is built
    or written, on the CPU as on the card."""
    opts = dqn.make_parser().parse_args(
        shlex.split(flags) + ["--device", "cpu", "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    with pytest.raises(SystemExit, match=REFUSED[flags]):
        dqn.train(opts)
    assert not (tmp_path / "m.jsonl").exists()


PORTED = ("--export-policy", "--tb-dir")


@pytest.mark.parametrize("flag", PORTED)
def test_ported_flag_runs(flag, tmp_path):
    """``--export-policy`` and ``--tb-dir``, refused at startup until their
    ROADMAP items were ported, run on the CPU: the artifact loads and acts
    on float32 low-dim observations (action indices in [0, 5)), and the logdir holds each
    ``train`` event's ``eval_ep_len`` at its segment."""
    out, jsonl = str(tmp_path / "out"), tmp_path / "m.jsonl"
    dqn.main(shlex.split(TOY) + ["--device", "cpu", "--metrics-jsonl", str(jsonl), flag, out])
    events = [json.loads(line) for line in jsonl.read_text().splitlines()]
    if flag == "--export-policy":
        from cartpoleplusplus_tpu_torch.utils import export

        act = export.load_policy(out, "cpu")(torch.zeros((3, 2, 2, 7)))
        assert act.shape == (3,) and 0 <= int(act.min()) and int(act.max()) < 5
        assert events[-1]["event"] == "export_policy" and events[-1]["bytes"] > 0
    else:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(out)
        acc.Reload()
        assert [(e.step, e.value) for e in acc.Scalars("train/eval_ep_len")] == [
            (e["segment"], e["eval_ep_len"]) for e in events if e["event"] == "train"]


def test_use_batch_norm_is_refused_by_name(capsys):
    """DQN's parser has no ``--use-batch-norm`` (nor has the JAX one):
    argparse stops on it and names it."""
    for parser in (dqn.make_parser(), _jax_parser()):
        with pytest.raises(SystemExit) as e:
            parser.parse_args(["--use-batch-norm"])
        assert e.value.code == 2
        assert "unrecognized arguments: --use-batch-norm" in capsys.readouterr().err


def test_train_refuses_cpu_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dqn.main(["--num-envs", "4"])
    with pytest.raises(SystemExit, match="--eval-only needs --ckpt-dir"):
        dqn.main(["--device", "cpu", "--eval-only", "--ckpt-dir", str(tmp_path),
                  "--num-envs", "4", "--num-eval", "4", "--max-episode-len", "3"])


@pytest.mark.parametrize("flags,want,note", [
    ("", (1.0, 0.05), None),
    ("--noisy", (0.0, 0.0), "# --noisy: eps schedule -> 0 (learned exploration)"),
    ("--noisy --eps-start 0.3", (0.3, 0.0), "# --noisy: unset eps flag backfilled with 0.0"),
    ("--noisy --eps-start 1.0 --eps-end 0.05", (1.0, 0.05), None),
    ("--eps-end 0.2", (1.0, 0.2), None),
])
def test_eps_defaults_and_noisy_backfill(flags, want, note, capsys):
    """JAX ``train``'s ε defaults: 1.0/0.05, or under ``--noisy`` each unset
    flag 0 with its stderr note; an explicit flag is kept."""
    opts = dqn.make_parser().parse_args(shlex.split(flags))
    assert (opts.eps_start, opts.eps_end) == (None if "--eps-start" not in flags else want[0],
                                              None if "--eps-end" not in flags else want[1])
    dqn.fill_eps_defaults(opts)
    assert (opts.eps_start, opts.eps_end) == want
    err = capsys.readouterr().err
    assert (note in err) if note else "--noisy" not in err


@pytest.mark.parametrize("flags,match", [
    ("--n-step 2 --num-envs 4 --replay-capacity 8", "needs replay capacity"),
    ("--n-step 3 --num-envs 16 --replay-capacity 8", "needs the s2-free block replay"),
])
def test_nstep_rejects_degenerate_capacity(flags, match):
    """tests/test_nstep.py::test_nstep_rejects_degenerate_capacity's stop
    (capacity below n + 1 blocks), and the s2-free replay n-step needs,
    with JAX's messages, on both sides."""
    argv = shlex.split(flags) + shlex.split(
        "--num-train-batches 1 --num-eval 4 --action-repeats 2 --steps-per-repeat 2 "
        "--max-episode-len 10 --steps-per-segment 2 --batch-size 4 --warmup-steps 1")
    with pytest.raises(SystemExit, match=match):
        jdqn.train(_jax_parser().parse_args(argv))
    with pytest.raises(SystemExit, match=match):
        dqn.main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX and the port's ``train`` on the toy Rainbow argv, with
    checkpoints every segment."""
    tmp = tmp_path_factory.mktemp("dqn")
    argv = shlex.split(TOY)
    jfinal = jdqn.train(_jax_parser().parse_args(
        argv + ["--metrics-jsonl", str(tmp / "jax.jsonl"), "--ckpt-dir", str(tmp / "j"),
                "--ckpt-freq", "1"]))
    final = dqn.main(argv + ["--device", "cpu", "--metrics-jsonl", str(tmp / "port.jsonl"),
                             "--ckpt-dir", str(tmp / "port"), "--ckpt-freq", "1"])
    return SimpleNamespace(tmp=tmp, argv=argv, jfinal=jfinal, final=final)


def test_train_logs_what_jax_logs(trained):
    """Both trains on one argv: the same events in order, each with JAX's
    fields in JAX's order (no ``double_reset_frac``), equal ``segment`` and
    ``env_steps``, ``eps`` 0 under ``--noisy``; the same checkpoint names;
    the learning script logs what ``train`` logs, between its header and
    summary."""
    t = trained
    want, got = _events(t.tmp / "jax.jsonl"), _events(t.tmp / "port.jsonl")
    assert [e["event"] for e in got] == [e["event"] for e in want] == ["train", "train"]
    for g, w in zip(got, want):
        assert list(g) == list(w) == FIELDS
        assert (g["segment"], g["env_steps"], g["eps"]) == (w["segment"], w["env_steps"], 0.0)
        assert g["loss"] > 0.0 and w["loss"] > 0.0
    assert [e["env_steps"] for e in got] == [20, 40]
    assert 0.0 < t.final <= 10.0 and 0.0 < t.jfinal <= 10.0
    jax_files = sorted(p.name.replace(".msgpack", ".pt") for p in (t.tmp / "j").iterdir())
    assert sorted(p.name for p in (t.tmp / "port").iterdir()) == jax_files == [
        "ckpt_1.pt", "ckpt_2.pt"]

    out = t.tmp / "script.jsonl"
    script = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_dqn_rainbow.py"), "--segments",
         "2", "--out", str(out), "--", "--device", "cpu", *t.argv],
        cwd=str(t.tmp), capture_output=True, text=True, timeout=300)
    assert script.returncode == 0, script.stderr
    logged = _events(out)
    assert [e["event"] for e in logged] == ["header", "train", "train", "summary"]
    for g, w in zip(logged[1:3], got):
        assert list(g) == list(w)
        assert (g["segment"], g["env_steps"]) == (w["segment"], w["env_steps"])
    assert logged[0]["argv"][-len(t.argv):] == t.argv and logged[0]["segments"] == 2
    assert logged[-1]["env_steps"] == 40 and logged[-1]["reached_gate"] is False


def _flat(d, p=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{p}{k}/"))
        else:
            out[f"{p}{k}"] = v
    return out


def _assert_equal(a, b):
    a, b = _flat(a), _flat(b)
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_resume_is_exact(trained, tmp_path):
    """The run resumed from its own ckpt_1 ends in the state the unbroken
    run ended in, byte for byte: networks, Adam and its schedule, the
    replay with its priorities, env states, obs, generator, ``env_steps``;
    the resumed run logs a ``restore`` of step 1 and segment 2 only."""
    os.makedirs(tmp_path / "resumed")
    shutil.copy(trained.tmp / "port" / "ckpt_1.pt", tmp_path / "resumed" / "ckpt_1.pt")
    dqn.main(trained.argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "resumed"),
                             "--ckpt-freq", "1", "--metrics-jsonl", str(tmp_path / "r.jsonl")])
    once = checkpoint.load_raw(str(trained.tmp / "port"), 2)
    _assert_equal(checkpoint.load_raw(str(tmp_path / "resumed"), 2), once)
    assert once["replay"]["priority"].shape == (64,) and once["replay"]["size"] == 40
    assert once["replay"]["action"].dtype == torch.int32 and once["env_steps"] == 10
    assert once["sched"]["last_epoch"] > 0
    events = _events(tmp_path / "r.jsonl")
    assert [(e["event"], e.get("segment", e.get("step"))) for e in events] == [
        ("restore", 1), ("train", 2)]


def test_skip_replay_checkpoint_and_resume(trained, tmp_path):
    """``--ckpt-skip-replay`` drops the replay and its priorities from the
    file; the resume restores the rest and refills an empty replay."""
    d = tmp_path / "lean"
    dqn.main(trained.argv + ["--device", "cpu", "--ckpt-dir", str(d), "--ckpt-skip-replay",
                             "--metrics-jsonl", str(tmp_path / "a.jsonl")])
    raw = checkpoint.load_raw(str(d), 2)
    assert raw["replay"]["s1"].shape == raw["replay"]["priority"].shape == (0,)
    assert raw["replay"]["size"] == 0 and raw["env_steps"] == 10
    full = checkpoint.load_raw(str(trained.tmp / "port"), 2)
    _assert_equal({k: v for k, v in raw.items() if k != "replay"},
                  {k: v for k, v in full.items() if k != "replay"})
    argv = list(trained.argv)
    argv[argv.index("--num-train-batches") + 1] = "3"
    dqn.main(argv + ["--device", "cpu", "--ckpt-dir", str(d), "--ckpt-skip-replay",
                     "--metrics-jsonl", str(tmp_path / "b.jsonl")])
    assert [e["segment"] for e in _events(tmp_path / "b.jsonl") if e["event"] == "train"] == [3]


def test_eval_only_equals_a_fresh_eval(trained, tmp_path):
    """``--eval-only`` restores the latest checkpoint (``--ckpt-best`` the
    best) and logs the greedy eval a fresh QNetwork with the saved weights
    gives on the same generator seed; nothing is trained."""
    d = tmp_path / "ck"
    dqn.main(trained.argv + ["--device", "cpu", "--ckpt-dir", str(d), "--ckpt-best",
                             "--metrics-jsonl", str(tmp_path / "t.jsonl")])
    for extra, step in (([], 2), (["--ckpt-best"], None)):
        jsonl = tmp_path / f"e{len(extra)}.jsonl"
        got = dqn.main(trained.argv + ["--device", "cpu", "--ckpt-dir", str(d), "--eval-only",
                                       "--metrics-jsonl", str(jsonl), *extra])
        events = _events(jsonl)
        assert [e["event"] for e in events] == ["restore", "eval_only"]
        if step is None:
            step = checkpoint.best_meta(str(d))["step"]
            raw = torch.load(d / "ckpt_best.pt", weights_only=True)["state"]
        else:
            raw = checkpoint.load_raw(str(d), step)
        assert events[1]["segment"] == step
        opts = dqn.make_parser().parse_args(trained.argv)
        cfg = config_from_opts(opts, discrete_actions=True)
        q = QNetwork(cfg.obs_shape, dueling=True, num_atoms=51, noisy=True, device="cpu")
        q.load_state_dict(raw["params"])
        elen, erew = eval_rollout(make_venv(cfg, 4, device="cpu"), dqn.greedy_act(q),
                                  torch.Generator().manual_seed(opts.seed + 1))
        assert (events[1]["eval_ep_len"], events[1]["eval_ep_rew"]) == (float(elen), float(erew))
        assert got == float(elen)
    assert sorted(p.name for p in d.iterdir()) == ["ckpt_2.pt", "ckpt_best.pt",
                                                    "ckpt_best.pt.json"]

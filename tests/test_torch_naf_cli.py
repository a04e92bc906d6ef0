"""The port's NAF program on the CPU: its CLI against the JAX package's (the
same flags, defaults and choices, the same ``CartpoleConfig``; unported
flags refused by name at startup), its ``train`` beside the JAX ``train``
on one toy argv with ``--use-batch-norm`` (the same events, fields in
JAX's order, segments and env steps) with the learning script's log,
checkpoints (a resume that ends byte for byte where the unbroken run ends,
``--ckpt-skip-replay``), ``--eval-only`` (``--ckpt-best``) equal to a
fresh eval of the saved network, and ``naf_params_from_jax_checkpoint`` on
the checkpoint the JAX CLI wrote: the greedy µ on its carried observations
within 2e-2 of the scale of JAX ``greedy_act``'s (the bf16 bound of
tests/test_torch_slice.py; 3.7e-9 against 0.027 measured on the CPU) and
the batch statistics copied exactly.

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import naf as jnaf
from cartpoleplusplus_tpu.env.config import config_from_opts as jconfig_from_opts
from cartpoleplusplus_tpu.models import NAFNetwork as JNAF
from cartpoleplusplus_tpu_torch.agents import naf
from cartpoleplusplus_tpu_torch.agents.common import eval_rollout, make_venv
from cartpoleplusplus_tpu_torch.env.config import config_from_opts
from cartpoleplusplus_tpu_torch.models.networks import NAFNetwork
from cartpoleplusplus_tpu_torch.utils import checkpoint
from cartpoleplusplus_tpu_torch.utils.params import naf_params_from_jax_checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scripts/sweep.sh's NAF recipe, tests/test_learning.py's NAF smoke flags,
# and the config-5 pixel argv chip_smoke.py's naf_cli runs.
NAF_ANNEAL = """--num-envs 128 --num-eval 64 --eval-freq 100 --steps-per-segment 25
  --batch-size 256 --replay-capacity 131072 --warmup-steps 40 --num-train-batches 5000
  --learning-rate 3e-4 --lr-schedule cosine --reward-scale 0.1 --grad-clip 10
  --ou-sigma-min 0.05 --ou-decay-steps 100000 --seed 0 --metrics-jsonl runs/sweep_naf_s0.jsonl"""
_SMOKE = """--num-train-batches 60 --reward-scale 0.1 --grad-clip 10.0 --num-envs 32
  --num-eval 32 --action-repeats 2 --steps-per-repeat 3 --max-episode-len 60 --eval-freq 20
  --steps-per-segment 25 --batch-size 64 --replay-capacity 4096 --warmup-steps 10 --seed 0"""
ARGVS = {"naf_anneal": NAF_ANNEAL, "smoke": _SMOKE, "defaults": "",
         "pixels": """--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2
           --pixel-encoder conv --num-envs 512 --replay-capacity 8192 --batch-size 256
           --use-batch-norm --learning-rate 3e-4 --lr-schedule cosine""",
         "every_naf_flag": """--tau 0.01 --batch-size 64 --replay-capacity 4096
           --warmup-steps 5 --steps-per-segment 10 --ou-theta 0.2 --ou-sigma 0.3
           --ou-sigma-min 0.1 --ou-decay-steps 1000 --use-batch-norm --reward-scale 0.5
           --grad-clip 5 --lr-schedule cosine --num-devices 1 --ckpt-best --eval-only"""}
TOY = """--num-train-batches 2 --num-envs 4 --num-eval 4 --action-repeats 2
  --steps-per-repeat 2 --max-episode-len 10 --steps-per-segment 5 --batch-size 8
  --replay-capacity 64 --warmup-steps 1 --eval-freq 1 --use-batch-norm
  --reward-scale 0.1 --grad-clip 10 --lr-schedule cosine --ou-sigma-min 0.05
  --ou-decay-steps 20"""
FIELDS = ["ts", "elapsed_s", "event", "segment", "env_steps", "loss", "mean_reward",
          "eval_ep_len", "eval_ep_rew"]


def _jax_parser():
    parser = jcommon.make_parser("t")
    jnaf.add_naf_opts(parser)
    return parser


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parser_matches_jax(name):
    argv = shlex.split(ARGVS[name])
    want = vars(_jax_parser().parse_args(argv))
    got = vars(naf.make_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want


def test_parser_choices_match_jax():
    def choices(parser):
        return {a.dest: (a.option_strings, a.choices, a.nargs, a.type, a.default)
                for a in parser._actions if a.dest not in ("help", "device")}

    assert choices(naf.make_parser()) == choices(_jax_parser())
    for argv in (["--pixel-encoder", "mlp"], ["--lr-schedule", "linear"], ["--tau", "x"]):
        with pytest.raises(SystemExit):
            naf.make_parser().parse_args(argv)


@pytest.mark.parametrize("name", ["naf_anneal", "pixels"])
def test_config_from_opts_matches_jax(name):
    argv = shlex.split(ARGVS[name])
    want = jconfig_from_opts(_jax_parser().parse_args(argv), discrete_actions=False)
    got = config_from_opts(naf.make_parser().parse_args(argv), discrete_actions=False)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name


# flag argv → what its refusal must say (the JAX CLIs' words)
REFUSED = {
    "--num-processes 2 --coordinator h:1":
        r"--num-processes > 1 needs --num-devices set to the job-global device count",
    "--num-devices 2 --replay-capacity 4097":
        r"--num-envs and --replay-capacity must be divisible by --num-devices",
}


@pytest.mark.parametrize("flags", sorted(REFUSED))
def test_unported_flag_stops_at_startup(flags, tmp_path):
    """The JAX package's multi-process contract (and the divisibility its
    multi-device CLI branch demands): each refused before anything is built
    or written, on the CPU as on the card."""
    opts = naf.make_parser().parse_args(
        shlex.split(flags) + ["--device", "cpu", "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    with pytest.raises(SystemExit, match=REFUSED[flags]):
        naf.train(opts)
    assert not (tmp_path / "m.jsonl").exists()


PORTED = ("--export-policy", "--tb-dir")


@pytest.mark.parametrize("flag", PORTED)
def test_ported_flag_runs(flag, tmp_path):
    """``--export-policy`` and ``--tb-dir``, refused at startup until their
    ROADMAP items were ported, run on the CPU: the artifact loads and acts
    on float32 low-dim observations, and the logdir holds each
    ``train`` event's ``eval_ep_len`` at its segment."""
    out, jsonl = str(tmp_path / "out"), tmp_path / "m.jsonl"
    naf.main(shlex.split(TOY) + ["--device", "cpu", "--metrics-jsonl", str(jsonl), flag, out])
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
        naf.main(["--num-envs", "4"])
    with pytest.raises(SystemExit, match="--eval-only needs --ckpt-dir"):
        naf.main(["--device", "cpu", "--eval-only", "--ckpt-dir", str(tmp_path),
                  "--num-envs", "4", "--num-eval", "4", "--max-episode-len", "3"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX and the port's ``train`` on the toy argv (batch norm on), with
    checkpoints every segment."""
    tmp = tmp_path_factory.mktemp("naf")
    argv = shlex.split(TOY)
    jfinal = jnaf.train(_jax_parser().parse_args(
        argv + ["--metrics-jsonl", str(tmp / "jax.jsonl"), "--ckpt-dir", str(tmp / "j"),
                "--ckpt-freq", "1"]))
    final = naf.main(argv + ["--device", "cpu", "--metrics-jsonl", str(tmp / "port.jsonl"),
                             "--ckpt-dir", str(tmp / "port"), "--ckpt-freq", "1"])
    return SimpleNamespace(tmp=tmp, argv=argv, jfinal=jfinal, final=final)


def test_train_logs_what_jax_logs(trained):
    """Both trains on one argv: the same events in order, each with JAX's
    fields in JAX's order, equal ``segment`` and ``env_steps``; the same
    checkpoint names; the learning script logs what ``train`` logs, between
    its header and summary."""
    t = trained
    want, got = _events(t.tmp / "jax.jsonl"), _events(t.tmp / "port.jsonl")
    assert [e["event"] for e in got] == [e["event"] for e in want] == ["train", "train"]
    for g, w in zip(got, want):
        assert list(g) == list(w) == FIELDS
        assert (g["segment"], g["env_steps"]) == (w["segment"], w["env_steps"])
        assert g["loss"] > 0.0 and w["loss"] > 0.0
    assert [e["env_steps"] for e in got] == [20, 40]
    assert 0.0 < t.final <= 10.0 and 0.0 < t.jfinal <= 10.0
    jax_files = sorted(p.name.replace(".msgpack", ".pt") for p in (t.tmp / "j").iterdir())
    assert sorted(p.name for p in (t.tmp / "port").iterdir()) == jax_files == [
        "ckpt_1.pt", "ckpt_2.pt"]

    out = t.tmp / "script.jsonl"
    script = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_naf_anneal.py"), "--segments",
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
    run ended in, byte for byte: both networks with their batch statistics,
    Adam and its schedule, the replay, env states, obs, OU noise, generator,
    ``env_steps``; the resumed run logs a ``restore`` of step 1 and segment
    2 only."""
    os.makedirs(tmp_path / "resumed")
    shutil.copy(trained.tmp / "port" / "ckpt_1.pt", tmp_path / "resumed" / "ckpt_1.pt")
    naf.main(trained.argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "resumed"),
                             "--ckpt-freq", "1", "--metrics-jsonl", str(tmp_path / "r.jsonl")])
    once = checkpoint.load_raw(str(trained.tmp / "port"), 2)
    _assert_equal(checkpoint.load_raw(str(tmp_path / "resumed"), 2), once)
    assert once["replay"]["size"] == 40 and once["env_steps"] == 10
    assert once["sched"]["last_epoch"] > 0
    for net in ("variables", "target_variables"):
        assert float(once[net]["encoder.batch_norm.mean"].abs().max()) > 0.0
    events = _events(tmp_path / "r.jsonl")
    assert [(e["event"], e.get("segment", e.get("step"))) for e in events] == [
        ("restore", 1), ("train", 2)]


def test_skip_replay_checkpoint_and_resume(trained, tmp_path):
    """``--ckpt-skip-replay`` drops the replay from the file; the resume
    restores the rest and refills an empty replay."""
    d = tmp_path / "lean"
    naf.main(trained.argv + ["--device", "cpu", "--ckpt-dir", str(d), "--ckpt-skip-replay",
                             "--metrics-jsonl", str(tmp_path / "a.jsonl")])
    raw = checkpoint.load_raw(str(d), 2)
    assert raw["replay"]["s1"].shape == (0,) and raw["replay"]["size"] == 0
    full = checkpoint.load_raw(str(trained.tmp / "port"), 2)
    _assert_equal({k: v for k, v in raw.items() if k != "replay"},
                  {k: v for k, v in full.items() if k != "replay"})
    argv = list(trained.argv)
    argv[argv.index("--num-train-batches") + 1] = "3"
    naf.main(argv + ["--device", "cpu", "--ckpt-dir", str(d), "--ckpt-skip-replay",
                     "--metrics-jsonl", str(tmp_path / "b.jsonl")])
    assert [e["segment"] for e in _events(tmp_path / "b.jsonl") if e["event"] == "train"] == [3]


def test_eval_only_equals_a_fresh_eval(trained, tmp_path):
    """``--eval-only`` restores the latest checkpoint (``--ckpt-best`` the
    best) and logs the greedy eval a fresh NAFNetwork with the saved weights
    and statistics gives on the same generator seed; nothing is trained."""
    d = tmp_path / "ck"
    naf.main(trained.argv + ["--device", "cpu", "--ckpt-dir", str(d), "--ckpt-best",
                             "--metrics-jsonl", str(tmp_path / "t.jsonl")])
    for extra, step in (([], 2), (["--ckpt-best"], None)):
        jsonl = tmp_path / f"e{len(extra)}.jsonl"
        got = naf.main(trained.argv + ["--device", "cpu", "--ckpt-dir", str(d), "--eval-only",
                                       "--metrics-jsonl", str(jsonl), *extra])
        events = _events(jsonl)
        assert [e["event"] for e in events] == ["restore", "eval_only"]
        if step is None:
            step = checkpoint.best_meta(str(d))["step"]
            raw = torch.load(d / "ckpt_best.pt", weights_only=True)["state"]
        else:
            raw = checkpoint.load_raw(str(d), step)
        assert events[1]["segment"] == step
        opts = naf.make_parser().parse_args(trained.argv)
        cfg = config_from_opts(opts, discrete_actions=False)
        net = NAFNetwork(cfg.obs_shape, use_batch_norm=True, device="cpu")
        net.load_state_dict(raw["variables"])
        elen, erew = eval_rollout(make_venv(cfg, 4, device="cpu"), naf.greedy_act(net),
                                  torch.Generator().manual_seed(opts.seed + 1))
        assert (events[1]["eval_ep_len"], events[1]["eval_ep_rew"]) == (float(elen), float(erew))
        assert got == float(elen)
    assert sorted(p.name for p in d.iterdir()) == ["ckpt_2.pt", "ckpt_best.pt",
                                                    "ckpt_best.pt.json"]


def test_jax_checkpoint_reader_matches_jax_greedy(trained):
    """``naf_params_from_jax_checkpoint`` on the JAX CLI's own ckpt_2
    (low-dim, 4 envs, ``--use-batch-norm``): the batch statistics of both
    networks copied exactly (moved from their init by the run), and the
    greedy µ on the carried observations within 2e-2 of the scale of JAX
    ``greedy_act``'s."""
    path = trained.tmp / "j" / "ckpt_2.msgpack"
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    got = naf_params_from_jax_checkpoint(str(path))
    assert got["env_steps"] == 10 and tuple(got["obs"].shape) == (4, 2, 2, 7)
    for port_key, jax_key in (("net", "variables"), ("target_net", "target_variables")):
        stats = raw[jax_key]["batch_stats"]["ObsEncoder_0"]["BatchNorm_0"]
        for k in ("mean", "var"):
            np.testing.assert_array_equal(got[port_key][f"encoder.batch_norm.{k}"].numpy(),
                                          np.asarray(stats[k]))
        assert float(np.abs(stats["mean"]).max()) > 0.0
    opts = naf.make_parser().parse_args(trained.argv)
    cfg = config_from_opts(opts, discrete_actions=False)
    net = NAFNetwork(cfg.obs_shape, use_batch_norm=True, device="cpu")
    net.load_state_dict(got["net"])
    mu = naf.greedy_act(net)(got["obs"])
    jnet = JNAF(action_dim=2, hidden=(100, 50), use_batch_norm=True)
    want = np.asarray(jnaf.greedy_act(jnet)(jax.tree.map(jnp.asarray, raw["variables"]),
                                            jnp.asarray(raw["obs"])))
    print(f"greedy mu: largest |port - JAX| {np.abs(mu.numpy() - want).max():.3g}, "
          f"largest |JAX| {np.abs(want).max():.3g}")
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(mu.numpy(), want, rtol=0, atol=2e-2 * np.abs(want).max())

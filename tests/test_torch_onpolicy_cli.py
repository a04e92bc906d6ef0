"""The port's on-policy programs (PPO and LRPG) on the CPU: their CLIs
against the JAX package's (the same flags, defaults and choices; the same
``CartpoleConfig``; an env count ``--num-devices`` does not divide refused
at startup), their
``train`` beside the JAX ``train`` on one toy argv (the same events,
fields, update numbers and env steps), a resume from 2 to 4 updates (the
counterpart of ``tests/test_ppo.py::test_ppo_resume``), ``--eval-only``
and ``--ckpt-best``, no quiet fall back to the CPU, the weights of a JAX
checkpoint written by the JAX package's own ``train`` carried across
(greedy actions within the bf16 bound), and the learning scripts' logs.

Whole runs are compared by outcome, never by curve (BASELINE.md r5).
"""

import copy
import dataclasses
import json
import os
import re
import shlex
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import lrpg as jlrpg
from cartpoleplusplus_tpu.agents import ppo as jppo
from cartpoleplusplus_tpu.env.config import config_from_opts as jconfig_from_opts
from cartpoleplusplus_tpu.models import DiscretePolicy as JDiscretePolicy
from cartpoleplusplus_tpu.models import GaussianActor as JGaussianActor
from cartpoleplusplus_tpu_torch.agents import common, lrpg, ppo
from cartpoleplusplus_tpu_torch.env.config import config_from_opts
from cartpoleplusplus_tpu_torch.models.networks import DiscretePolicy, GaussianActor
from cartpoleplusplus_tpu_torch.utils import checkpoint
from cartpoleplusplus_tpu_torch.utils.params import (
    lrpg_params_from_jax_checkpoint,
    ppo_params_from_jax_checkpoint,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-2
AGENTS = {"ppo": (ppo, jppo, jppo.add_ppo_opts), "lrpg": (lrpg, jlrpg, jlrpg.add_lrpg_opts)}
# scripts/chip_queue6.sh's low-dim PPO recipe, chip_smoke.py's config-5
# argvs, runs/lrpg_big.jsonl's shape, and every flag of each agent.
ARGVS = {
    "ppo": {
        "lowdim": """--num-envs 128 --num-eval 64 --eval-freq 25 --rollout-steps 128
          --ppo-epochs 4 --ppo-minibatches 8 --learning-rate 3e-4 --lr-schedule cosine
          --reward-scale 0.1 --grad-clip 0.5 --num-train-batches 600 --seed 0""",
        "pixels": """--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2
          --pixel-encoder conv --num-envs 512 --rollout-steps 32 --ppo-epochs 4
          --ppo-minibatches 4 --learning-rate 3e-4 --lr-schedule cosine --reward-scale 0.1
          --grad-clip 0.5 --num-eval 64 --eval-freq 1 --ckpt-freq 1""",
        "every_flag": """--ppo-clip 0.1 --gae-lambda 0.9 --entropy-coef 0.01 --value-coef 1.0
          --num-devices 1 --hidden 64 32 --pixel-pool 2 --ckpt-best --eval-only
          --ckpt-skip-replay""",
        "defaults": "",
    },
    "lrpg": {
        "lowdim": "--num-envs 512 --num-eval 64 --eval-freq 100 --num-train-batches 6000",
        "pixels": """--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2
          --pixel-encoder conv --num-envs 512 --max-episode-len 40 --num-eval 64
          --eval-freq 1 --ckpt-freq 1""",
        "every_flag": """--num-devices 1 --reward-calc angle_action --hidden 64 32
          --ckpt-best --eval-only""",
        "defaults": "",
    },
}
TOY = {
    "ppo": """--num-train-batches 2 --num-envs 8 --num-eval 4 --eval-freq 1 --action-repeats 2
      --steps-per-repeat 2 --max-episode-len 10 --rollout-steps 8 --ppo-minibatches 2
      --ppo-epochs 2 --hidden 16 16""",
    "lrpg": """--num-train-batches 2 --num-envs 8 --num-eval 4 --eval-freq 1 --action-repeats 2
      --steps-per-repeat 2 --max-episode-len 10 --hidden 16 16""",
}


def _jax_parser(agent):
    parser = jcommon.make_parser("t")
    AGENTS[agent][2](parser)
    return parser


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("agent,name", [(a, n) for a in AGENTS for n in sorted(ARGVS[a])])
def test_parser_matches_jax(agent, name):
    argv = shlex.split(ARGVS[agent][name])
    want = vars(_jax_parser(agent).parse_args(argv))
    got = vars(AGENTS[agent][0].make_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want


@pytest.mark.parametrize("agent", sorted(AGENTS))
def test_parser_choices_match_jax(agent):
    def choices(parser):
        return {a.dest: (a.option_strings, a.choices, a.nargs, a.type, a.default)
                for a in parser._actions if a.dest not in ("help", "device")}

    assert choices(AGENTS[agent][0].make_parser()) == choices(_jax_parser(agent))


@pytest.mark.parametrize("agent", sorted(AGENTS))
def test_config_from_opts_matches_jax(agent):
    argv = shlex.split(ARGVS[agent]["pixels"])
    discrete = agent == "lrpg"
    want = jconfig_from_opts(_jax_parser(agent).parse_args(argv), discrete_actions=discrete)
    got = config_from_opts(AGENTS[agent][0].make_parser().parse_args(argv),
                           discrete_actions=discrete)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name


@pytest.mark.parametrize("agent", sorted(AGENTS))
def test_num_devices_stops_at_startup(agent, tmp_path):
    """The JAX CLI's multi-device branch refuses --num-envs 64 over 3
    devices, before anything is built or written."""
    opts = AGENTS[agent][0].make_parser().parse_args(
        ["--num-devices", "3", "--device", "cpu", "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    with pytest.raises(SystemExit, match=r"--num-envs must be divisible by --num-devices"):
        AGENTS[agent][0].train(opts)
    assert not (tmp_path / "m.jsonl").exists()


@pytest.mark.parametrize("agent", sorted(AGENTS))
def test_train_refuses_cpu_fallback(agent, monkeypatch, tmp_path):
    main = AGENTS[agent][0].main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--num-envs", "4"])
    with pytest.raises(SystemExit, match="--eval-only needs --ckpt-dir"):
        main(["--device", "cpu", "--eval-only", "--ckpt-dir", str(tmp_path), "--num-envs", "4",
              "--num-eval", "4", "--max-episode-len", "3"])


@pytest.fixture(scope="module", params=sorted(AGENTS))
def trained(request, tmp_path_factory):
    """The JAX ``train`` and the port's on the agent's toy argv, each with
    a checkpoint directory and a metrics jsonl."""
    agent = request.param
    port, jmod, _ = AGENTS[agent]
    tmp = tmp_path_factory.mktemp(agent)
    argv = shlex.split(TOY[agent])
    jfinal = jmod.train(_jax_parser(agent).parse_args(
        argv + ["--metrics-jsonl", str(tmp / "jax.jsonl"), "--ckpt-dir", str(tmp / "j")]))
    final = port.main(argv + ["--device", "cpu", "--metrics-jsonl", str(tmp / "port.jsonl"),
                              "--ckpt-dir", str(tmp / "port"), "--ckpt-freq", "1"])
    return SimpleNamespace(agent=agent, port=port, tmp=tmp, argv=argv, jfinal=jfinal,
                           final=final)


def test_train_logs_what_jax_logs(trained):
    """Both trains on one argv: the same events in order, each with the
    same fields, equal ``update`` (and PPO's ``env_steps``); the learning
    script logs what ``train`` logs, between its header and summary."""
    t = trained
    want, got = _events(t.tmp / "jax.jsonl"), _events(t.tmp / "port.jsonl")
    assert [e["event"] for e in got] == [e["event"] for e in want] == ["train", "train"]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert g["update"] == w["update"] and g.get("env_steps") == w.get("env_steps")
        assert all(np.isfinite(v) for k, v in g.items() if k not in ("event",))
    if t.agent == "ppo":
        assert [e["env_steps"] for e in got] == [64, 128]
    assert 0.0 < t.final <= 10.0 and 0.0 < t.jfinal <= 10.0
    assert sorted(p.name for p in (t.tmp / "j").iterdir()) == ["ckpt_2.msgpack"]

    out = t.tmp / "script.jsonl"
    script = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", f"torch_{t.agent}_lowdim.py"), "--updates",
         "2", "--out", str(out), "--", "--device", "cpu", *t.argv],
        cwd=str(t.tmp), capture_output=True, text=True, timeout=300)
    assert script.returncode == 0, script.stderr
    logged = _events(out)
    assert [e["event"] for e in logged] == ["header", "train", "train", "summary"]
    for g, w in zip(logged[1:3], got):
        assert list(g) == list(w) and g["update"] == w["update"]
    assert logged[0]["argv"][-len(t.argv):] == t.argv and logged[0]["updates"] == 2
    summary = logged[-1]
    assert summary["best_eval"] == max(e["eval_ep_len"] for e in logged[1:3])
    assert summary["reached_gate"] is False
    assert summary["env_steps"] == (128 if t.agent == "ppo" else None)


def test_resume_from_2_to_4(trained):
    """Resume from update 2 to 4 (``tests/test_ppo.py::test_ppo_resume``):
    the checkpoints hold ``update`` 2 and 4; the restored state (networks,
    optimizer, generator, and PPO's env states and obs) equals the saved
    one; the resumed run logs updates 3 and 4 after a ``restore``."""
    t = trained
    ck = str(t.tmp / "port")
    assert checkpoint.latest_step(ck) == 2
    assert checkpoint.load_raw(ck, 1)["update"] == 1 and checkpoint.load_raw(ck, 2)["update"] == 2
    saved = checkpoint.load_raw(ck, 2)
    restored = {}

    def spy(real):
        def restore(d, target):
            out, step = real(d, target)
            restored[step] = copy.deepcopy(out.state_dict())
            return out, step
        return restore

    real = checkpoint.restore_latest
    checkpoint.restore_latest = spy(real)
    try:
        t.port.main(t.argv + ["--device", "cpu", "--ckpt-dir", ck, "--num-train-batches", "4",
                              "--metrics-jsonl", str(t.tmp / "resume.jsonl")])
    finally:
        checkpoint.restore_latest = real
    assert checkpoint.latest_step(ck) == 4 and checkpoint.load_raw(ck, 4)["update"] == 4
    assert list(restored) == [2]
    flat = lambda d, p="": ({f"{p}{k}": v for k, v in d.items() if not isinstance(v, dict)} |
                            {x: y for k, v in d.items() if isinstance(v, dict)
                             for x, y in flat(v, f"{p}{k}/").items()})
    a, b = flat(restored[2]), flat(saved)
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    events = _events(t.tmp / "resume.jsonl")
    assert [(e["event"], e.get("update")) for e in events] == [
        ("restore", None), ("train", 3), ("train", 4)]
    assert events[0]["step"] == 2
    if t.agent == "ppo":
        assert "env_states" in saved and "replay" not in saved
        assert checkpoint.strip_replay(saved) == saved


def test_eval_only_and_ckpt_best(trained, tmp_path):
    """``--ckpt-best`` keeps the best eval's state; ``--eval-only`` evals the
    latest checkpoint and, with ``--ckpt-best``, the best one, logging an
    ``eval_only`` event each; ``--ckpt-skip-replay`` is a harmless no-op."""
    t = trained
    argv = t.argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--metrics-jsonl",
                     str(tmp_path / "m.jsonl"), "--ckpt-skip-replay"]
    t.port.main(argv + ["--ckpt-best"])
    meta = checkpoint.best_meta(str(tmp_path))
    trains = _events(tmp_path / "m.jsonl")
    assert meta["eval_ep_len"] == max(e["eval_ep_len"] for e in trains)
    assert meta["step"] in (1, 2)
    latest = t.port.main(argv + ["--eval-only"])
    best = t.port.main(argv + ["--eval-only", "--ckpt-best"])
    evals = [e for e in _events(tmp_path / "m.jsonl") if e["event"] == "eval_only"]
    assert [e["segment"] for e in evals] == [2, meta["step"]]
    assert (latest, best) == (evals[0]["eval_ep_len"], evals[1]["eval_ep_len"])
    assert latest == trains[-1]["eval_ep_len"]


def test_ppo_schedule_spans_every_optimizer_step(tmp_path):
    """PPO's cosine schedule decays over updates × epochs × minibatches
    (not segments × steps): after 1 update of a 4-update run (``stop_at``)
    the learning rate is optax's schedule at epochs × minibatches."""
    argv = shlex.split(TOY["ppo"].replace("--num-train-batches 2", "--num-train-batches 4")) + [
        "--device", "cpu", "--lr-schedule", "cosine", "--learning-rate", "3e-4",
        "--ckpt-dir", str(tmp_path)]
    ppo.main(argv, stop_at=1)
    raw = torch.load(tmp_path / "ckpt_1.pt", weights_only=True)
    steps = 2 * 2
    assert raw["sched"]["last_epoch"] == steps and raw["update"] == 1
    want = optax.cosine_decay_schedule(3e-4, 4 * steps, alpha=0.02)(steps)
    assert raw["opt_state"]["param_groups"][0]["lr"] == pytest.approx(float(want), rel=1e-6)
    assert common.make_lr(SimpleNamespace(lr_schedule="cosine"), 3e-4, 4 * steps)(steps) == \
        pytest.approx(float(want), rel=1e-6)


def _jax_raw(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def test_jax_checkpoint_carried_across(trained):
    """A checkpoint written by the JAX package's own ``train`` (toy size),
    read without flax by ``*_from_jax_checkpoint``: the port's greedy
    actions equal flax's within the bf16 bound on the same obs (PPO: the
    checkpoint's carried obs; LRPG: the argmax wherever flax's top two
    logits differ by more than that bound)."""
    t = trained
    path = str(t.tmp / "j" / "ckpt_2.msgpack")
    raw = _jax_raw(path)
    kw = dict(use_raw_pixels=False, hidden=(16, 16))
    obs_shape = (2, 2, 7)
    if t.agent == "ppo":
        got = ppo_params_from_jax_checkpoint(path)
        assert got["update"] == 2 and tuple(got["obs"].shape) == (8, *obs_shape)
        assert tuple(got["env_states"]["pos"].shape) == (8, 2, 3)
        obs = np.asarray(raw["obs"])
        want = np.asarray(jppo.greedy_act(JGaussianActor(action_dim=2, **kw))(
            raw["params"]["actor"], jnp.asarray(obs)))
        actor = GaussianActor(obs_shape, device="cpu", **kw)
        actor.load_state_dict(got["actor"])
        act = ppo.greedy_act(actor)(got["obs"]).numpy()
        np.testing.assert_allclose(act, want, rtol=0, atol=ATOL)
        value = ppo.ValueNetwork(obs_shape, device="cpu", **kw)
        value.load_state_dict(got["value"])
        return
    got = lrpg_params_from_jax_checkpoint(path)
    assert got["update"] == 2
    obs = np.random.default_rng(0).normal(scale=0.5, size=(256, *obs_shape)).astype(np.float32)
    jpolicy = JDiscretePolicy(num_actions=5, **kw)
    logits = np.asarray(jpolicy.apply(raw["params"], jnp.asarray(obs)))
    want = np.asarray(jlrpg.greedy_act(jpolicy)(raw["params"], jnp.asarray(obs)))
    policy = DiscretePolicy(obs_shape, device="cpu", **kw)
    policy.load_state_dict(got["policy"])
    with torch.no_grad():
        got_logits = policy(torch.from_numpy(obs)).numpy()
    bound = ATOL * np.abs(logits).max()
    np.testing.assert_allclose(got_logits, logits, rtol=0, atol=bound)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * bound
    assert clear.sum() >= 128
    act = lrpg.greedy_act(policy)(torch.from_numpy(obs)).numpy()
    np.testing.assert_array_equal(act[clear], want[clear])


@pytest.mark.parametrize("agent", sorted(AGENTS))
def test_learning_script_refuses_cpu_fallback(agent, tmp_path):
    """Without CUDA and without ``--device cpu`` the script stops before
    training, and writes nothing."""
    out = tmp_path / "x.jsonl"
    script = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", f"torch_{agent}_lowdim.py"), "--out",
         str(out)], cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
        | {"CUDA_VISIBLE_DEVICES": ""})
    assert script.returncode == 1
    assert re.search(r"torch\.cuda\.is_available\(\) is False", script.stderr)
    assert not out.exists()

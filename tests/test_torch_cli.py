"""The port's DDPG CLI against the JAX package's: the same flags, defaults
and choices (``vars(opts)`` equal for the recipes' argv, the port adding
only ``--device``), the same ``CartpoleConfig`` from them, the JAX
package's multi-process contract refused at startup in its words, and
``--export-policy`` and ``--tb-dir`` writing what they write.
"""

import dataclasses
import json
import shlex

import pytest
import torch

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import ddpg as jddpg
from cartpoleplusplus_tpu.env.config import config_from_opts as jconfig_from_opts
from cartpoleplusplus_tpu_torch.agents import common, ddpg
from cartpoleplusplus_tpu_torch.env.config import CartpoleConfig, config_from_opts

# scripts/pixel_td3_artifacts.sh (the pixel TD3 recipe), scripts/chip_queue.sh's
# ddpg_it3_learn, and tests/test_learning.py's test_ddpg_improves (_SMOKE).
TD3_ARTIFACTS = """--use-raw-pixels --num-cameras 2 --obs-pool 2 --pixel-encoder conv
  --num-envs 512 --num-eval 64 --eval-freq 500
  --steps-per-segment 25 --batch-size 256 --replay-capacity 65536
  --warmup-steps 40 --num-train-batches 15000
  --actor-learning-rate 1e-4 --critic-learning-rate 3e-4 --lr-schedule cosine
  --reward-scale 0.1 --grad-clip 10 --aug-shift 2
  --ou-sigma-min 0.05 --ou-decay-steps 250000
  --twin-critic --policy-delay 2 --target-noise 0.2
  --pallas-render
  --ckpt-dir runs/ckpt_pixels_td3 --ckpt-freq 5000 --ckpt-skip-replay
  --event-log-out runs/ddpg_pixels_td3_eval.events
  --seed 0 --metrics-jsonl runs/ddpg_pixels_td3_art.jsonl"""
IT3_LEARN = """--solver-iters 3
  --num-envs 128 --num-eval 64 --eval-freq 100
  --steps-per-segment 25 --batch-size 256 --replay-capacity 131072
  --warmup-steps 40 --num-train-batches 1500
  --reward-scale 0.1 --grad-clip 10
  --seed 0 --metrics-jsonl runs/ddpg_it3_s0.jsonl"""
SMOKE = """--num-train-batches 60 --reward-scale 0.1 --grad-clip 10.0
  --num-envs 32 --num-eval 32 --action-repeats 2 --steps-per-repeat 3
  --max-episode-len 60 --eval-freq 20 --steps-per-segment 25 --batch-size 64
  --replay-capacity 4096 --warmup-steps 10 --seed 0"""
ARGVS = {"td3_artifacts": TD3_ARTIFACTS, "it3_learn": IT3_LEARN, "smoke": SMOKE, "defaults": "",
         "every_env_flag": """--action-force 40 --initial-force 50 --action-repeats 2
           --steps-per-repeat 4 --max-episode-len 150 --reward-calc angle_action
           --use-raw-pixels --render-width 48 --render-height 48 --num-cameras 2
           --obs-pool 4 --obs-samples 3 --pos-threshold 1.5 --angle-threshold 0.25
           --solver-iters 5 --no-render-raster --pallas-physics --hidden 64 32 16
           --pixel-pool 2 --ckpt-best --eval-only --coordinator h:1 --process-id 0
           --per-alpha 0.5 --per-beta0 0.3 --per-eps 0.02 --tau 0.01 --ou-theta 0.2
           --ou-sigma 0.3 --learning-rate 3e-4 --gamma 0.98 --target-noise-clip 0.4"""}


def _jax_opts(argv):
    parser = jcommon.make_parser("t")
    jddpg.add_ddpg_opts(parser)
    return parser.parse_args(argv)


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parser_matches_jax(name):
    argv = shlex.split(ARGVS[name])
    want = vars(_jax_opts(argv))
    got = vars(ddpg.make_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == want


def test_parser_choices_match_jax():
    def choices(parser):
        return {a.dest: (a.option_strings, a.choices, a.nargs, a.type) for a in parser._actions
                if a.dest not in ("help", "device")}

    parser = jcommon.make_parser("t")
    jddpg.add_ddpg_opts(parser)
    assert choices(ddpg.make_parser()) == choices(parser)
    port = ddpg.make_parser()
    for argv in (["--pixel-encoder", "mlp"], ["--lr-schedule", "linear"],
                 ["--num-cameras", "3"], ["--reward-calc", "nope"]):
        with pytest.raises(SystemExit):
            port.parse_args(argv)


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_config_from_opts_matches_jax(name):
    argv = shlex.split(ARGVS[name])
    want = jconfig_from_opts(_jax_opts(argv), discrete_actions=False)
    got = config_from_opts(ddpg.make_parser().parse_args(argv), discrete_actions=False)
    assert isinstance(got, CartpoleConfig)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name), field.name


TOY = """--num-train-batches 2 --num-envs 4 --num-eval 4 --action-repeats 2
  --steps-per-repeat 2 --max-episode-len 10 --steps-per-segment 3 --batch-size 8
  --replay-capacity 64 --warmup-steps 1 --eval-freq 1"""
# flag argv → what its refusal must say (the JAX maybe_init_multihost's words)
REFUSED = {
    "--num-processes 2 --num-devices 2": r"--num-processes > 1 needs --coordinator host:port",
    "--num-processes 2 --num-devices 1 --coordinator h:1":
        r"--num-processes > 1 needs --num-devices set to the job-global device count",
}


@pytest.mark.parametrize("flags", sorted(REFUSED))
def test_unported_flag_stops_at_startup(flags, tmp_path):
    """The JAX package's multi-process contract (and the divisibility its
    multi-device CLI branch demands): each refused before anything is built
    or written, on the CPU as on the card."""
    opts = ddpg.make_parser().parse_args(
        shlex.split(flags) + ["--device", "cpu", "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    with pytest.raises(SystemExit, match=REFUSED[flags]):
        ddpg.train(opts)
    assert not (tmp_path / "m.jsonl").exists()


PORTED = ("--export-policy", "--tb-dir")


@pytest.mark.parametrize("flag", PORTED)
def test_ported_flag_runs(flag, tmp_path):
    """``--export-policy`` and ``--tb-dir``, refused at startup until their
    ROADMAP items were ported, run on the CPU: the artifact loads and acts
    on float32 low-dim observations, and the logdir holds each
    ``train`` event's ``eval_ep_len`` at its segment."""
    out, jsonl = str(tmp_path / "out"), tmp_path / "m.jsonl"
    ddpg.main(shlex.split(TOY) + ["--device", "cpu", "--metrics-jsonl", str(jsonl), flag, out])
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


def test_defaults_of_refused_flags_pass():
    opts = ddpg.make_parser().parse_args(
        ["--n-step", "1", "--num-devices", "1", "--num-processes", "1", "--pallas-render",
         "--pallas-physics"])
    assert common.maybe_init_multihost(opts) is None
    assert not common.launches_ranks(opts, None)


def test_eval_only_without_checkpoint_is_an_error(tmp_path):
    opts = ddpg.make_parser().parse_args(
        ["--device", "cpu", "--eval-only", "--ckpt-dir", str(tmp_path), "--num-envs", "4",
         "--num-eval", "4", "--max-episode-len", "3"])
    with pytest.raises(SystemExit, match="--eval-only needs --ckpt-dir"):
        ddpg.train(opts)


@pytest.mark.parametrize("obs_samples,expect", [(0, True), (2, False)])
def test_render_raster_resolves_per_config(obs_samples, expect):
    """The tristate resolves through prefer_raster for pixel configs, to
    False for low-dim ones; an explicit flag stands."""
    opts = ddpg.make_parser().parse_args(
        ["--use-raw-pixels", "--num-cameras", "2", "--obs-pool", "2",
         "--obs-samples", str(obs_samples)])
    cfg = config_from_opts(opts, discrete_actions=False)
    assert common.resolve_render_raster(cfg, opts) is expect and opts.render_raster is expect
    low = ddpg.make_parser().parse_args([])
    assert common.resolve_render_raster(config_from_opts(low, False), low) is False
    forced = ddpg.make_parser().parse_args(["--use-raw-pixels", "--no-render-raster"])
    assert common.resolve_render_raster(config_from_opts(forced, False), forced) is False


def test_replay_capacity_trims_to_whole_blocks():
    """As the JAX replay trims: the defaults (100000 at 64 envs) give 99968."""
    assert common.replay_capacity(100000, 64) == 99968
    assert common.replay_capacity(4096, 32) == 4096
    assert common.replay_capacity(100, 0) == 100
    with pytest.raises(SystemExit, match="fewer than two blocks"):
        common.replay_capacity(100, 64)


def test_train_refuses_cpu_fallback(monkeypatch):
    """Without --device cpu and without CUDA, train stops before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ddpg.main(["--num-envs", "4"])

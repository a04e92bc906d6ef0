"""The port's pixel TD3 learning run (``scripts/torch_ddpg_pixels_ab2k.py``)
on the CPU: its recipe is the JAX package's ``ab2k`` run
(``scripts/chip_queue6.sh:210-221``) flag for flag and parses alike under
both packages' DDPG parsers; ``ddpg.main(stop_at=N)`` logs what a whole run
of the same flags logs for its first N segments; the script at toy size
writes its header, train lines and summary; and the summary's flatline rule
tells the JAX package's round-5 raster flatline from a run that learned."""

import importlib.util
import json
import os
import shlex
import subprocess
import sys

import pytest

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import ddpg as jddpg
from cartpoleplusplus_tpu_torch.agents import ddpg
from cartpoleplusplus_tpu_torch.utils import learning_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "torch_ddpg_pixels_ab2k", os.path.join(REPO, "scripts", "torch_ddpg_pixels_ab2k.py"))
ab2k = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ab2k)

# The JAX run's lines in scripts/chip_queue6.sh (1-based, inclusive).
QUEUE6_LINES = (210, 221)
# The recipe at toy size on the CPU: a few envs, small frames, short episodes.
TOY = ["--device", "cpu", "--num-envs", "4", "--num-eval", "4", "--render-width", "16",
       "--render-height", "16", "--replay-capacity", "64", "--batch-size", "8",
       "--warmup-steps", "1", "--steps-per-segment", "3", "--eval-freq", "1",
       "--max-episode-len", "8", "--action-repeats", "2", "--steps-per-repeat", "2"]
TIMING = ("ts", "elapsed_s")


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _queue6_run() -> list:
    with open(os.path.join(REPO, "scripts", "chip_queue6.sh")) as f:
        lines = f.read().splitlines()[QUEUE6_LINES[0] - 1:QUEUE6_LINES[1]]
    return shlex.split(" ".join(line.rstrip("\\") for line in lines))


def test_recipe_is_the_jax_runs_argv():
    tokens = _queue6_run()
    assert tokens[:6] == ["T=1500", "step", "ab2k_${backend}_s$s", "python", "-m",
                          "cartpoleplusplus_tpu.agents.ddpg"]
    flag = tokens.index("$flag")
    assert tokens[6:flag] == ab2k.RECIPE
    assert tokens[flag:flag + 4] == ["$flag", "--seed", "$s", "--metrics-jsonl"]
    with open(os.path.join(REPO, "scripts", "chip_queue6.sh")) as f:
        assert ("flag=--render-raster; [ $backend = slab ] && flag=--no-render-raster"
                in f.read())
    assert ab2k.BACKEND_FLAG == {"raster": "--render-raster", "slab": "--no-render-raster"}


@pytest.mark.parametrize("backend", ["slab", "raster"])
def test_recipe_parses_alike_under_both_packages(backend):
    argv = ab2k.recipe(backend, 3)
    jparser = jcommon.make_parser("t")
    jddpg.add_ddpg_opts(jparser)
    want = vars(jparser.parse_args(argv))
    got = vars(ddpg.make_parser().parse_args(argv))
    shared = set(want) & set(got)
    assert set(got) - shared == {"device"}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert got["render_raster"] is (backend == "raster") and got["seed"] == 3
    assert (got["num_envs"], got["num_train_batches"], got["obs_samples"]) == (512, 2000, 2)


def test_stop_at_logs_the_whole_runs_first_segments(tmp_path):
    """``ddpg.main(stop_at=2)`` of a 4-segment schedule logs, timing aside,
    the events a whole 4-segment run logs for segments 1 and 2."""
    argv = ab2k.recipe("slab", 0, [*TOY, "--num-train-batches", "4"])
    ddpg.main([*argv, "--metrics-jsonl", str(tmp_path / "cut.jsonl")], stop_at=2)
    ddpg.main([*argv, "--metrics-jsonl", str(tmp_path / "whole.jsonl")])
    strip = lambda es: [{k: v for k, v in e.items() if k not in TIMING} for e in es]
    cut, whole = strip(_events(tmp_path / "cut.jsonl")), strip(_events(tmp_path / "whole.jsonl"))
    assert [e["segment"] for e in cut] == [1, 2]
    assert [e["segment"] for e in whole] == [1, 2, 3, 4]
    assert cut == whole[:2]


def test_script_at_toy_size_writes_header_trains_and_summary(tmp_path):
    out = tmp_path / "run.jsonl"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_ddpg_pixels_ab2k.py"),
         "--segments", "2", "--seed", "1", "--out", str(out), "--", *TOY],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    logged = _events(out)
    assert [e["event"] for e in logged] == ["header", "train", "train", "summary"]
    head, trains, summary = logged[0], logged[1:3], logged[-1]
    assert head["argv"] == ab2k.recipe("slab", 1, TOY) and head["segments"] == 2
    assert head["device"] == "cpu"
    assert [e["segment"] for e in trains] == [1, 2]
    assert summary["launches"] == {}  # the CPU runs the plain versions
    assert summary["s_per_segment"] == pytest.approx(
        trains[1]["elapsed_s"] - trains[0]["elapsed_s"])
    assert summary["double_reset_frac_last"] == pytest.approx(
        sum(e["double_reset_frac"] for e in trains) / 2)
    assert summary["flatlined"] is None  # no eval after segment 500
    assert summary["gate"] == 45.0 and summary["reached_gate"] is False
    assert summary["best_eval"] == max(e["eval_ep_len"] for e in trains)


@pytest.mark.parametrize("name, flat", [("ddpg_ab_2cam_raster", True),
                                        ("ddpg_ab2k_slab_s1", False),
                                        ("ddpg_ab2k_raster_s2", False)])
def test_flatline_rule_on_the_jax_runs(name, flat):
    """True on the JAX package's round-5 raster A/B (flat at 4.5-4.9 for
    15000 segments, double resets 0.81-0.82), false on its ab2k runs."""
    trains = [e for e in _events(os.path.join(REPO, "runs", f"{name}.jsonl"))
              if e["event"] == "train"]
    assert learning_run.flatlined(trains) is flat
    summary = learning_run.summarize(trains, "segment", ab2k.GATE, 1, 1.0,
                                     trains[-1]["eval_ep_len"], {}, trains[-1]["segment"])
    assert summary["flatlined"] is flat
    assert summary["reached_gate"] is (not flat)


def test_flatline_needs_both_signs():
    """Low evals alone, or double resets alone, are not the signature."""
    low = [{"segment": 600 + 100 * i, "eval_ep_len": 5.0, "double_reset_frac": 0.1}
           for i in range(3)]
    resets = [dict(e, eval_ep_len=30.0, double_reset_frac=0.9) for e in low]
    both = [dict(e, double_reset_frac=0.85) for e in low]
    early = [dict(e, segment=e["segment"] - 500) for e in both]
    assert [learning_run.flatlined(t) for t in (low, resets, both, early)] == [
        False, False, True, None]

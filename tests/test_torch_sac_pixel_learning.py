"""The port's pixel SAC learning run (``scripts/torch_sac_pixels.py``) on the
CPU: its recipe is the JAX package's ``sac_pixels`` run
(``scripts/chip_queue6.sh:230-239``, and ``:169-178`` for seed 1) flag for
flag apart from its three cuts, and parses alike under both packages' SAC
parsers, slab adding only ``obs_samples`` 2; ``sac.main(stop_at=N)`` logs
what a whole run of the same flags logs for its first N segments; the
script at toy size writes its header, train lines and summary; the four
JAX runs give the gates the script holds; and ``utils/learning_run``'s
other callers keep their summaries' keys."""

import importlib.util
import json
import math
import os
import shlex
import subprocess
import sys

import pytest

from cartpoleplusplus_tpu.agents import common as jcommon
from cartpoleplusplus_tpu.agents import sac as jsac
from cartpoleplusplus_tpu_torch.agents import sac
from cartpoleplusplus_tpu_torch.utils import learning_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


sacpx = _load("torch_sac_pixels")

# The JAX runs' lines in scripts/chip_queue6.sh (1-based, inclusive): seeds
# 0 and 2 (the loop's body), then seed 1.
QUEUE6_LINES = {"$s": (230, 239), "1": (169, 178)}
# The four JAX runs the gate is taken from (TPU, an eval every 500).
JAX_RUNS = ("sac_pixels_fix_s0", "sac_pixels_s1", "sac_pixels_fix_s2", "sac_cfg5_s0")
# The recipe at toy size on the CPU: a few envs, small frames, short episodes.
TOY = ["--device", "cpu", "--num-envs", "4", "--num-eval", "4", "--render-width", "16",
       "--render-height", "16", "--replay-capacity", "64", "--batch-size", "8",
       "--warmup-steps", "1", "--steps-per-segment", "3", "--eval-freq", "1",
       "--max-episode-len", "8", "--action-repeats", "2", "--steps-per-repeat", "2"]
TIMING = ("ts", "elapsed_s")
# The summary's keys before ref_points and carry.
SUMMARY_KEYS = {"event", "seed", "wall_s", "s_per_segment", "final_eval", "best_eval",
                "best_segment", "first_segment_at_gate", "gate", "reached_gate", "env_steps",
                "launches", "double_reset_frac_last", "flatlined"}

# scripts/ab2k_table.py's default output on the recorded runs, as it printed
# before it took options.
AB2K_TABLE = """\
| run | best ≤1000 | ≤1500 | ≤2000 | first ≥ 45 | eval at 100 | double_reset_frac, last 5 | flatlined | card | s/segment | kernels |
|---|---|---|---|---|---|---|---|---|---|---|
| ddpg_ab2k_raster_s1.jsonl | 31.58 | 46.83 | 58.00 | 1500 | 8.25 | 0.008-0.017 | false | TPU (JAX) |  |  |
| ddpg_ab2k_raster_s2.jsonl | 40.31 | 54.62 | 67.08 | 1300 | 8.38 | 0.000-0.026 | false | TPU (JAX) |  |  |
| ddpg_ab2k_slab_s1.jsonl | 28.52 | 38.95 | 50.94 | 1700 | 7.77 | 0.000-0.035 | false | TPU (JAX) |  |  |
| ddpg_ab2k_slab_s2.jsonl | 28.45 | 37.00 | 45.27 | 1800 | 8.44 | 0.017-0.039 | false | TPU (JAX) |  |  |
| torch_ddpg_pixels_ab2k_raster_s0.jsonl | 33.12 | 48.55 | 64.91 | 1500 | 13.48 | 0.007-0.025 | false | NVIDIA H100 80GB HBM3, 700.00 W | 0.525 | render_batched_raster, render_repeats_raster, step_repeats, step_substeps |
| torch_ddpg_pixels_ab2k_raster_s1.jsonl | 39.55 | 53.25 | 68.39 | 1200 | 10.56 | 0.000-0.012 | false | NVIDIA H100 80GB HBM3, 700.00 W | 0.435 | render_batched_raster, render_repeats_raster, step_repeats, step_substeps |
| torch_ddpg_pixels_ab2k_raster_s2.jsonl | 12.47 | 21.12 | 31.94 | None | 4.75 | 0.081-0.151 | false | NVIDIA H100 80GB HBM3, 700.00 W | 0.471 | render_batched_raster, render_repeats_raster, step_repeats, step_substeps |
| torch_ddpg_pixels_ab2k_slab_s0.jsonl | 41.22 | 63.05 | 95.12 | 1200 | 7.80 | 0.011-0.028 | false | NVIDIA H100 80GB HBM3, 700.00 W | 0.449 | render_batched, render_repeats, step_repeats, step_substeps |
| torch_ddpg_pixels_ab2k_slab_s1.jsonl | 38.33 | 64.92 | 168.72 | 1300 | 9.95 | 0.000-0.020 | false | NVIDIA H100 80GB HBM3, 700.00 W | 0.408 | render_batched, render_repeats, step_repeats, step_substeps |
| torch_ddpg_pixels_ab2k_slab_s2.jsonl | 45.31 | 61.67 | 76.75 | 1000 | 8.16 | 0.009-0.022 | false | NVIDIA H100 80GB HBM3, 700.00 W | 0.466 | render_batched, render_repeats, step_repeats, step_substeps |
"""


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _queue6_run(seed: str) -> list:
    first, last = QUEUE6_LINES[seed]
    with open(os.path.join(REPO, "scripts", "chip_queue6.sh")) as f:
        lines = f.read().splitlines()[first - 1:last]
    return shlex.split(" ".join(line.rstrip("\\") for line in lines))


@pytest.mark.parametrize("seed", list(QUEUE6_LINES))
def test_recipe_is_the_jax_runs_argv_less_its_cuts(seed):
    tokens = _queue6_run(seed)
    step = "sac_pixels_fix_s$s" if seed == "$s" else "sac_pixels_s1"
    assert tokens[:6] == ["T=3700", "step", step, "python", "-m",
                          "cartpoleplusplus_tpu.agents.sac"]
    tail = tokens.index("--seed")
    assert tokens[tail:tail + 3] == ["--seed", seed, "--metrics-jsonl"]
    flags = tokens[6:tail]
    # Cut 2: the checkpoint flags, whose directory is the JAX run's own.
    ckpt = flags.index("--ckpt-dir")
    assert flags[ckpt:] == ["--ckpt-dir", f"runs/ckpt_sac_pixels_s{seed}", "--ckpt-freq",
                            "5000", "--ckpt-skip-replay"]
    flags = flags[:ckpt]
    # Cut 1: an eval every 100 segments for the recipe's 500.
    at = flags.index("--eval-freq")
    assert flags[at + 1] == "500"
    flags[at + 1] = "100"
    assert flags == sacpx.RECIPE
    # Cut 3: stop_at, the schedule kept whole.
    assert "--num-train-batches" in flags and sacpx.SEGMENTS < 15000


@pytest.mark.parametrize("backend", ["raster", "slab"])
def test_recipe_parses_alike_under_both_packages(backend):
    argv = sacpx.recipe(backend, 3)
    jparser = jcommon.make_parser("t")
    jsac.add_sac_opts(jparser)
    want = vars(jparser.parse_args(argv))
    got = vars(sac.make_parser().parse_args(argv))
    shared = set(want) & set(got)
    assert set(got) - shared == {"device"}
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert (got["seed"], got["num_envs"], got["num_train_batches"], got["alpha_min"],
            got["pixel_encoder"], got["ckpt_dir"]) == (3, 512, 15000, 0.02, "conv", None)
    raster = vars(sac.make_parser().parse_args(sacpx.recipe("raster", 3)))
    assert {k for k in got if got[k] != raster[k]} == (
        {"obs_samples"} if backend == "slab" else set())
    assert got["obs_samples"] == (2 if backend == "slab" else 0)


def test_stop_at_logs_the_whole_runs_first_segments(tmp_path):
    """``sac.main(stop_at=2)`` of a 4-segment schedule logs, timing aside,
    the events a whole 4-segment run logs for segments 1 and 2."""
    argv = sacpx.recipe("slab", 0, [*TOY, "--num-train-batches", "4"])
    sac.main([*argv, "--metrics-jsonl", str(tmp_path / "cut.jsonl")], stop_at=2)
    sac.main([*argv, "--metrics-jsonl", str(tmp_path / "whole.jsonl")])
    strip = lambda es: [{k: v for k, v in e.items() if k not in TIMING} for e in es]
    cut, whole = strip(_events(tmp_path / "cut.jsonl")), strip(_events(tmp_path / "whole.jsonl"))
    assert [e["segment"] for e in cut] == [1, 2]
    assert [e["segment"] for e in whole] == [1, 2, 3, 4]
    assert cut == whole[:2]


def test_script_at_toy_size_writes_header_trains_and_summary(tmp_path):
    out = tmp_path / "run.jsonl"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_sac_pixels.py"),
         "--segments", "2", "--seed", "1", "--out", str(out), "--", *TOY],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    logged = _events(out)
    assert [e["event"] for e in logged] == ["header", "train", "train", "summary"]
    head, trains, summary = logged[0], logged[1:3], logged[-1]
    assert head["argv"] == sacpx.recipe("raster", 1, TOY) and head["segments"] == 2
    assert head["device"] == "cpu" and head["script"] == "scripts/torch_sac_pixels.py"
    assert [e["segment"] for e in trains] == [1, 2]
    assert summary["launches"] == {}  # the CPU runs the plain versions
    assert summary["gate"] == sacpx.GATE == 65.0
    assert summary["ref_points"] == [500, 1000]
    # No eval at the JAX runs' points: no best there, and the gate not reached.
    assert summary["best_eval_ref"] is None and summary["reached_gate"] is False
    assert summary["best_eval"] == max(e["eval_ep_len"] for e in trains)
    assert (summary["alpha"], summary["entropy"]) == (trains[-1]["alpha"], trains[-1]["entropy"])
    assert set(summary) == SUMMARY_KEYS | {"ref_points", "best_eval_ref", "alpha", "entropy"}
    assert not (tmp_path / "run.jsonl.train").exists()


@pytest.mark.parametrize("n, gate, bests", [
    (1000, 65.0, (128.78125, 65.890625, 145.40625, 115.78125)),
    (1500, 128.0, (128.78125, 166.421875, 145.40625, 138.9375)),
])
def test_gate_from_the_four_jax_runs(n, gate, bests):
    """The lowest ``best_eval_ref`` of the four JAX runs over their evals at
    or before N, rounded down, is the gate; each of them reaches it."""
    got = []
    for name in JAX_RUNS:
        trains = [e for e in _events(os.path.join(REPO, "runs", f"{name}.jsonl"))
                  if e["event"] == "train" and e["segment"] <= n]
        s = learning_run.summarize(trains, "segment", gate, 0, 1.0, trains[-1]["eval_ep_len"], {},
                                   n, ref_points=tuple(range(500, n + 1, 500)),
                                   carry=sacpx.CARRY)
        assert s["reached_gate"] is True and s["alpha"] == pytest.approx(0.02, rel=1e-5)
        got.append(s["best_eval_ref"])
    assert tuple(got) == bests
    assert math.floor(min(got)) == gate == sacpx.GATES[n]


def test_ref_points_score_the_gate_at_them():
    """A run that beats the gate between the reference points only has not
    reached it; without ``ref_points`` it has, as before."""
    trains = [{"event": "train", "segment": s, "eval_ep_len": v, "elapsed_s": float(s)}
              for s, v in ((100, 90.0), (500, 20.0), (600, 70.0), (1000, 60.0))]
    plain = learning_run.summarize(trains, "segment", 65.0, 0, 1.0, 60.0, {}, 1000)
    ref = learning_run.summarize(trains, "segment", 65.0, 0, 1.0, 60.0, {}, 1000,
                                 ref_points=(500, 1000))
    assert plain["reached_gate"] is True and set(plain) == SUMMARY_KEYS
    assert ref["reached_gate"] is False and ref["best_eval_ref"] == 60.0
    assert ref["best_eval"] == plain["best_eval"] == 90.0


@pytest.mark.parametrize("script", ["torch_sac_lowdim", "torch_ppo_lowdim", "torch_lrpg_lowdim",
                                    "torch_dqn_rainbow", "torch_naf_anneal",
                                    "torch_ddpg_pixels_ab2k"])
def test_other_learning_scripts_keep_their_summary(script, monkeypatch):
    """The earlier learning scripts pass neither ``ref_points`` nor
    ``carry``, so their summaries keep the keys they had."""
    module = _load(script)
    calls = []
    monkeypatch.setattr(module.learning_run, "run", lambda **kw: calls.append(kw) or 0)
    assert module.main([]) == 0
    assert len(calls) == 1
    assert not {"ref_points", "carry"} & set(calls[0])
    counter = calls[0]["counter"]
    trains = [{"event": "train", counter: 1, "eval_ep_len": 5.0, "elapsed_s": 1.0}]
    summary = learning_run.summarize(trains, counter, calls[0]["gate"], 0, 1.0, 5.0, {}, 1)
    assert set(summary) == {k.replace("segment", counter) for k in SUMMARY_KEYS}


def test_sac_table_from_the_one_table_script(capsys):
    """``scripts/ab2k_table.py`` prints the SAC runs' table with its
    options; the JAX runs have no eval at segment 100, which prints empty."""
    table = _load("ab2k_table")
    table.main(["--cuts", "500,1000", "--gate", "65", "--at", "100,500,1000", "--ref-points",
                "500,1000", "--last", "alpha,entropy", "--horizon", "1000",
                os.path.join(REPO, "runs", "sac_pixels_s1.jsonl")])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("| run | best ≤500 | ≤1000 | first ≥ 65 | eval at 100 | eval at 500 | "
                        "eval at 1000 | best at 500, 1000 | ≥ 65 | double_reset_frac, last 5 | "
                        "flatlined | alpha, last eval | entropy, last eval | card | s/segment | "
                        "kernels |")
    assert lines[2] == ("| sac_pixels_s1.jsonl | 18.89 | 65.89 | 1000 |  | 18.89 | 65.89 | 65.89 "
                        "| true | 0.199-0.512 | false | 0.020 | 1.018 | TPU (JAX) |  |  |")
    assert len(lines) == 3


def test_table_script_default_is_the_ab2k_table(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    _load("ab2k_table").main([])
    assert capsys.readouterr().out == AB2K_TABLE

"""The port's bench (cartpoleplusplus_tpu_torch/utils/benchmark.py,
bench_torch.py) against the JAX bench it mirrors, on the CPU: the census
ceiling at the JAX bench's constant rate, the shared flags' defaults, the
suite's child argv, best-of-N windows, no fallback on a failing row, the
port's own record of measurements, the card probe, toy-size rows of every
kind through the plain versions, and the CLI."""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from cartpoleplusplus_tpu.utils import benchmark as jbench
from cartpoleplusplus_tpu_torch.utils import benchmark as bench

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX bench's measured TPU mix rate, its census_ceiling's constant.
JAX_MIX = 1.59e12
TOY = ["--device", "cpu", "--num-envs", "16", "--replay-capacity", "64", "--batch-size", "8",
       "--segments", "1", "--steps-per-segment", "2", "--min-wall-s", "0.01",
       "--bench-windows", "2"]


def _port_opts(argv=()):
    return bench.make_parser().parse_args(list(argv))


RENDER_FLAGS = [
    dict(render_raster=False, render_recip=True),
    dict(render_raster=False, render_recip=False),
    dict(render_raster=True),
    dict(render_raster=True, render_mxu=True),
]


@pytest.mark.parametrize("flags", RENDER_FLAGS, ids=["slab", "ratio", "raster", "raster_mxu"])
@pytest.mark.parametrize("row", bench.ROW_SPECS, ids=[tag for _, tag, _ in bench.ROW_SPECS])
def test_census_ceiling_matches_jax(row, flags):
    """At the JAX bench's constant rate the port's ceiling is the JAX
    bench's, for every suite row under every render mode."""
    _, _, overrides = row
    opts = _port_opts()
    for k, v in {**overrides, **flags}.items():
        setattr(opts, k, v)
    assert bench.census_ceiling(opts, JAX_MIX) == pytest.approx(jbench.census_ceiling(opts),
                                                                rel=1e-12)
    assert bench.census_ops_per_step(opts) == pytest.approx(JAX_MIX / jbench.census_ceiling(opts),
                                                            rel=1e-12)


def test_parser_defaults_match_jax():
    jparser = argparse.ArgumentParser()
    jbench.add_bench_opts(jparser)
    jdefaults, defaults = vars(jparser.parse_args([])), vars(_port_opts())
    dropped = {"pallas_render", "pallas_physics", "fused_step", "render_tile_e"}
    assert set(jdefaults) - set(defaults) == dropped
    for k in set(jdefaults) - dropped:
        assert defaults[k] == jdefaults[k], k
    assert defaults["device"] == "cuda"
    assert bench.ROW_SPECS == jbench.ROW_SPECS
    assert bench.DEFAULT_NUM_ENVS == jbench.DEFAULT_NUM_ENVS


@pytest.mark.parametrize("base_argv,overrides", [
    (["--num-envs", "128", "--no-render-recip"], {"num_cameras": 2, "obs_samples": 2}),
    (["--no-render-raster", "--render-mxu", "--raster-hoist", "--sim-only"], {"num_cameras": 1}),
    ([], {"lowdim": True, "num_envs": 8192}),
    (["--render-raster", "--trace-dir", "/tmp/t", "--device", "cpu"], {"obs_samples": 0}),
])
def test_child_argv_roundtrips_through_parser(base_argv, overrides):
    """The suite's child argv, parsed by the ``--single`` CLI, gives the
    parent's opts with the row's overrides; the tristate render_raster is
    kept (None stays None)."""
    parser = bench.make_parser()
    base = parser.parse_args(base_argv)
    argv = bench._child_argv(base, overrides)
    assert argv[1:3] == ["-m", "cartpoleplusplus_tpu_torch.utils.benchmark"]
    child = parser.parse_args(argv[3:])
    want = {**vars(base), **overrides, "single": True, "probe_timeout": 0.0}
    assert vars(child) == want
    assert child.render_raster is base.render_raster


def test_child_env_prepends_port_parent():
    env = bench._child_env()
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO


def test_best_of_n_reports_fastest_window_and_every_window_extends(monkeypatch):
    """Each window doubles its segments until it spans min_wall_s and starts
    at the size the previous one reached; the best window is the value."""
    calls = {"n": 0}

    def fake_build(opts):
        def segment(st):
            calls["n"] += 1
            return st, {"reward": torch.tensor(1.0)}
        return None, segment

    # window 1: t0 0.0, 5 segs at 1.0 → done; window 2: t0 10.0, 5 segs at
    # 10.1 (short) → 10 more... its first pass is 5 (the previous size), then
    # doubles to 10 total at 10.6; window 3: t0 20, 10 segs at 20.5 → done.
    times = iter([0.0, 1.0, 10.0, 10.1, 10.6, 20.0, 20.5])
    monkeypatch.setattr(bench, "build", fake_build)
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(times))
    opts = _port_opts(["--lowdim", "--segments", "5", "--num-envs", "4", "--steps-per-segment",
                       "2", "--min-wall-s", "0.5", "--bench-windows", "3", "--device", "cpu"])
    row = bench.run(opts)
    assert row["_windows"] == [40.0, 133.3, 160.0]
    assert row["value"] == 160.0 and row["_env_steps"] == 80 and row["_wall_s"] == 0.5
    assert calls["n"] == 1 + 5 + 10 + 10


def test_failing_row_raises_with_no_retry(monkeypatch):
    """A row whose warm-up raises propagates: no second build, no other
    render mode."""
    built = []

    def build(opts):
        built.append(opts.render_raster)

        def segment(st):
            raise RuntimeError("render: CUDA launch failed")
        return None, segment

    monkeypatch.setattr(bench, "build", build)
    with pytest.raises(RuntimeError, match="launch failed"):
        bench.run(_port_opts(["--render-raster", "--device", "cpu"]))
    assert built == [True]


def test_suite_drops_a_failing_row_and_reports_it(monkeypatch, capsys):
    """A row whose child fails is dropped (its attempts, no other kernel);
    the summary names it in ``error`` and the suite exits non-zero.  A row
    that passes on its second attempt says so in ``_attempts``, in its line
    and in the summary's meta.  The low-dim row runs at 8192 envs unless
    --num-envs says otherwise."""
    seen = []

    def fake_row(argv, timeout_s):
        child = bench.make_parser().parse_args(argv[3:])
        seen.append(child)
        if not child.lowdim and child.num_cameras == 1 and child.obs_samples == 0:
            return None
        if child.obs_samples == 1 and sum(1 for c in seen if c.obs_samples == 1) == 1:
            return None  # the 1-sample row fails once, then passes
        return {"metric": "m" if child.lowdim else "m_pixel_render", "value": 1.0,
                "unit": "u", "vs_baseline": 1e-7, "ceiling": 2.0, "vs_ceiling": 0.5,
                "_backend": "cpu"}

    monkeypatch.setattr(bench, "_run_row_subprocess", fake_row)
    rc = bench.main(["--device", "cpu", "--row-attempts", "2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 1
    assert [ln.get("config") for ln in lines[:-1]] == [
        label for label, tag, _ in bench.ROW_SPECS if tag != "_1cam_exact"]
    summary = lines[-1]
    assert "1cam_exact" in summary["error"] and summary["metric"] == "m_pixel_render_2cam_s2"
    assert len(summary["rows"]) == 3
    assert [ln["_attempts"] for ln in lines[:-1]] == [1, 2, 1]
    assert [r["meta"]["_attempts"] for r in summary["rows"]] == [1, 2, 1]
    assert sum(1 for c in seen if c.obs_samples == 0 and not c.lowdim) == 2  # two attempts
    assert all(c.render_raster is None for c in seen)  # never pinned to another mode
    assert [c.num_envs for c in seen if c.lowdim] == [8192]
    seen.clear()
    bench.main(["--device", "cpu", "--num-envs", "64"])
    capsys.readouterr()
    assert [c.num_envs for c in seen if c.lowdim] == [64]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_record_last_measured_keeps_card_rows_only(tmp_path):
    """CPU rows and rows without their card are never recorded; the port
    writes its own file and never the JAX bench's."""
    jax_file = os.path.join(REPO, "runs", "bench_last_measured.json")
    before = _sha(jax_file)
    assert os.path.basename(bench.LAST_MEASURED) == "bench_torch_last_measured.json"
    assert os.path.normpath(bench.LAST_MEASURED) != os.path.normpath(jax_file)
    path = str(tmp_path / "runs" / "lm.json")
    row = {"metric": "m", "value": 4.2e5, "unit": "u", "vs_baseline": 0.042, "_num_envs": 4096}
    bench.record_last_measured({**row, "_backend": "cpu"}, path)
    bench.record_last_measured({**row, "_backend": "cuda", "_device": "H100"}, path)
    assert bench.load_last_measured(path) is None
    card = {"_backend": "cuda", "_device": "NVIDIA H100 80GB HBM3", "_power_limit": "700.00 W"}
    bench.record_last_measured({**row, **card}, path)
    got = bench.load_last_measured(path)["m|num_envs=4096"]
    assert got["value"] == 4.2e5 and got["device"] == card["_device"]
    assert got["power_limit"] == "700.00 W" and got["recorded_by"] == "bench_torch"
    # a degraded re-measure keeps the best and is flagged
    bench.record_last_measured({**row, **card, "value": 1.0e5}, path)
    got = bench.load_last_measured(path)["m|num_envs=4096"]
    assert got["value"] == 1.0e5 and got["best"]["value"] == 4.2e5
    assert got["degraded_vs_best"] == pytest.approx(1.0e5 / 4.2e5, abs=1e-4)
    # a suite with one CPU row is not recorded
    suite = {"metric": "s", "value": 1.0, "rows": [{"meta": card}, {"meta": {"_backend": "cpu"}}]}
    bench.record_last_measured(suite, path)
    assert "suite" not in bench.load_last_measured(path)
    assert _sha(jax_file) == before


def test_probe_backend_times_out_fast(monkeypatch):
    monkeypatch.setattr(bench, "_PROBE_CODE", "import time; time.sleep(60)")
    t0 = time.perf_counter()
    assert bench.probe_backend(timeout_s=2) is False
    assert time.perf_counter() - t0 < 15
    monkeypatch.setattr(bench, "_PROBE_CODE", "pass")
    assert bench.probe_backend(timeout_s=30) is True


CONTRACT_KEYS = {"metric", "value", "unit", "vs_baseline", "ceiling", "vs_ceiling", "_wall_s",
                 "_windows", "_env_steps", "_num_envs", "_num_cameras", "_obs_samples",
                 "_backend", "_device", "_power_limit", "_peak_mem_mib", "_mix_ops_per_s",
                 "_census_ops_per_step", "_render_raster"}


@pytest.mark.parametrize("argv,metric,raster", [
    (["--sim-only", "--num-cameras", "2", "--obs-samples", "2"],
     "batched_env_steps_per_sec_per_chip_pixel_render_sim_only", False),
    (["--num-cameras", "2", "--obs-samples", "2"],
     "batched_env_steps_per_sec_per_chip_pixel_render", False),
    (["--num-cameras", "1", "--obs-samples", "0"],
     "batched_env_steps_per_sec_per_chip_pixel_render", True),
    (["--lowdim"], "batched_env_steps_per_sec_per_chip", False),
], ids=["sim_only_config5", "train_slab", "train_raster", "train_lowdim"])
def test_run_on_cpu_returns_the_contract(argv, metric, raster):
    """A toy row of each kind through the plain versions: the JAX bench's
    keys plus the port's, and no device number from the CPU."""
    opts = _port_opts(TOY + argv)
    row = bench.run(opts)
    assert CONTRACT_KEYS <= set(row)
    assert row["metric"] == metric and row["_render_raster"] is raster
    assert row["value"] > 0 and len(row["_windows"]) == 2 and row["_backend"] == "cpu"
    assert row["_env_steps"] % (16 * 2) == 0
    for k in ("ceiling", "vs_ceiling", "_device", "_power_limit", "_peak_mem_mib",
              "_mix_ops_per_s"):
        assert row[k] is None, k
    assert opts.render_raster is raster  # resolved on opts by build
    assert row["_census_ops_per_step"] == bench.census_ops_per_step(opts)


def test_run_with_trace_dir_writes_a_trace(tmp_path):
    row = bench.run(_port_opts(TOY + ["--lowdim", "--trace-dir", str(tmp_path)]))
    assert row["_traced"] is True and os.path.exists(row["_trace"])
    for k in ("_device_busy_share", "_device_ms_per_step", "_kernels_ms_per_step"):
        assert row[k] is None, k  # no device on the CPU


def _cli(args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "bench_torch.py", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_single_lowdim_on_cpu():
    out = _cli(["--single", "--lowdim", *TOY])
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert CONTRACT_KEYS <= set(row) and row["_backend"] == "cpu" and row["value"] > 0
    assert row["metric"] == "batched_env_steps_per_sec_per_chip"


def test_cli_without_card_prints_error_and_fails():
    """The default device is the card: without one, one error line and a
    non-zero exit, nothing run on the CPU."""
    out = _cli(["--single", "--lowdim"], timeout=120)
    assert out.returncode != 0
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "card unavailable" in line["error"]
    assert "north_star" in line and "last_measured" in line

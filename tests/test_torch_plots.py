"""The port's learning-curve CLI (``utils/plots.py``) in the three cases of
the JAX package's tests/test_plots.py, and its ``load_run`` against JAX's
on the same file."""

import json
import os

from cartpoleplusplus_tpu.utils import plots as jplots
from cartpoleplusplus_tpu_torch.utils import plots


def _write_run(path, n=5, extra=None):
    with open(path, "w") as f:
        for i in range(n):
            rec = {"event": "train", "segment": i, "env_steps": i * 100,
                   "eval_ep_len": 10.0 + i, **(extra or {})}
            f.write(json.dumps(rec) + "\n")
        f.write('{"event": "restore", "step": 3}\n')  # not a train event: ignored
        f.write("not json\n")  # a corrupt tail: ignored


def test_load_run_filters_train_events(tmp_path):
    p = os.path.join(str(tmp_path), "run.jsonl")
    _write_run(p, extra={"note": "x"})
    cols = plots.load_run(p)
    assert cols["eval_ep_len"] == [10.0, 11.0, 12.0, 13.0, 14.0]
    assert cols["env_steps"] == [0, 100, 200, 300, 400]
    assert "step" not in cols
    assert cols == jplots.load_run(p)


def test_cli_writes_png(tmp_path):
    runs = []
    for s in (0, 1):
        p = os.path.join(str(tmp_path), f"run_s{s}.jsonl")
        _write_run(p)
        runs.append(p)
    out = os.path.join(str(tmp_path), "curves.png")
    plots.main([*runs, "-o", out])
    assert os.path.getsize(out) > 1000
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_survives_missing_column(tmp_path, capsys):
    """A run without the y column warns and is skipped; the PNG is still
    written from the others."""
    good = os.path.join(str(tmp_path), "good.jsonl")
    _write_run(good)
    bad = os.path.join(str(tmp_path), "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps({"event": "train", "segment": 0}) + "\n")
    out = os.path.join(str(tmp_path), "c.png")
    plots.main([bad, good, "-o", out])
    assert os.path.exists(out)
    assert "has no column 'eval_ep_len'" in capsys.readouterr().err

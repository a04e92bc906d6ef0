"""Metrics logging: port of cartpoleplusplus_tpu.utils.metrics.

One JSON object per event in an optional jsonl file, in the JAX package's
line format (``ts``, ``elapsed_s``, ``event``, then the fields), a
human-readable line per event on stderr, and with ``tb_dir`` (``--tb-dir``)
the numeric fields as TensorBoard scalars.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional


def dts() -> str:
    """Datetime stamp."""
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())


class MetricsLogger:
    """stderr lines (unless ``quiet``), an optional jsonl sink (appended,
    flushed per line) and an optional TensorBoard sink.

    ``tb_dir``: each numeric field of an event is also written as the scalar
    ``<event>/<field>`` through ``torch.utils.tensorboard.SummaryWriter``;
    bools are labels, not curves, and ``segment`` is the step, not a
    scalar.  The step is the event's ``step`` field, else its ``segment``,
    else a count of the events logged.  Where ``tensorboard`` cannot be
    imported the logger says so on one stderr line and goes on with the
    jsonl and stderr sinks, as the JAX logger does.
    """

    def __init__(self, jsonl_path: Optional[str] = None, quiet: bool = False,
                 tb_dir: Optional[str] = None):
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._quiet = quiet
        self._t0 = time.monotonic()
        self._tb = None
        self._n = 0
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tb_dir)
            except Exception as exc:
                print(f"[metrics] tensorboard unavailable ({exc}); "
                      "continuing with JSONL/stderr only", file=sys.stderr)

    def log(self, event: str, **fields):
        record = {"ts": time.time(), "elapsed_s": round(time.monotonic() - self._t0, 3),
                  "event": event, **fields}
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._tb is not None:
            self._n += 1
            step = fields.get("step", fields.get("segment", self._n))
            if not isinstance(step, (int, float)) or isinstance(step, bool):
                step = self._n
            for k, v in fields.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool) and k != "segment":
                    self._tb.add_scalar(f"{event}/{k}", v, int(step))
        if not self._quiet:
            kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
            print(f"[{dts()}] {event} {kv}", file=sys.stderr)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return v

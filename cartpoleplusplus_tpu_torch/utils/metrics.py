"""Metrics logging: port of the jsonl half of cartpoleplusplus_tpu.utils.metrics.

One JSON object per event in an optional jsonl file, in the JAX package's
line format (``ts``, ``elapsed_s``, ``event``, then the fields), and a
human-readable line per event on stderr.  The TensorBoard sink
(``--tb-dir``) is not ported; the CLI refuses that flag.
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
    """stderr lines plus an optional jsonl sink (appended, flushed per line)."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.monotonic()

    def log(self, event: str, **fields):
        record = {"ts": time.time(), "elapsed_s": round(time.monotonic() - self._t0, 3),
                  "event": event, **fields}
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        print(f"[{dts()}] {event} {kv}", file=sys.stderr)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return v

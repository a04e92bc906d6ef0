"""A learning run from scratch, as the learning scripts
(``scripts/torch_{sac,ppo,lrpg}_lowdim.py``) make it: an agent's ``main``
on a recipe's flags, stopped after its first N segments or updates of the
recipe's schedule, its metrics jsonl wrapped in a header and a summary.

The jsonl at ``out`` holds a header line (event ``header``: the card's
name and power limit from ``nvidia-smi``, torch and CUDA versions, the
script, the argv and N), then the run's own events (one ``train`` line
per eval), then a ``summary`` line (best and final eval, where the best
was, the first eval at or above the gate, wall seconds).  Each line is
also printed to stdout.  A watchdog turns a hang into a traceback and a
nonzero exit.  Without CUDA, and without ``--device cpu`` among the flags,
it fails before training (the port never falls back to the CPU).
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Callable

import torch


def _emit(f, record: dict) -> None:
    line = json.dumps(record)
    f.write(line + "\n")
    f.flush()
    print(line, flush=True)


def card() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def run(*, script: str, agent_main: Callable, parser, argv: list, stop_at: int, counter: str,
        gate: float, seed: int, out: str, watchdog_s: float) -> int:
    """``agent_main(argv + ["--metrics-jsonl", …], stop_at=stop_at)`` →
    0, the jsonl written to ``out``; 1 without CUDA unless ``argv`` asks for
    the CPU.  ``counter``: the name of the run's unit in its ``train``
    events, "segment" or "update"."""
    on_cpu = parser.parse_args(argv).device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        print(f"{os.path.basename(script)}: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    smi = card()
    train_log = out + ".train"
    if os.path.exists(train_log):
        os.remove(train_log)
    faulthandler.dump_traceback_later(watchdog_s, exit=True)
    t0 = time.monotonic()
    try:
        final = agent_main([*argv, "--metrics-jsonl", train_log], stop_at=stop_at)
    finally:
        faulthandler.cancel_dump_traceback_later()
    wall = time.monotonic() - t0
    with open(train_log) as f:
        events = [json.loads(line) for line in f]
    os.remove(train_log)
    trains = [e for e in events if e["event"] == "train"]
    lens = [e["eval_ep_len"] for e in trains]
    best = max(lens)
    first_gate = next((e[counter] for e in trains if e["eval_ep_len"] >= gate), None)
    with open(out, "w") as f:
        _emit(f, {"event": "header", "nvidia_smi": smi,
                  "device": "cpu" if on_cpu else torch.cuda.get_device_name(0),
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "script": script, "argv": argv, f"{counter}s": stop_at})
        for e in events:
            _emit(f, e)
        _emit(f, {"event": "summary", "seed": seed, "wall_s": wall, "final_eval": final,
                  "best_eval": best, f"best_{counter}": trains[lens.index(best)][counter],
                  f"first_{counter}_at_gate": first_gate, "gate": gate,
                  "reached_gate": best >= gate, "env_steps": trains[-1].get("env_steps")})
    return 0

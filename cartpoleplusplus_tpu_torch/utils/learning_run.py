"""A learning run from scratch, as the learning scripts
(``scripts/torch_{sac,ppo,lrpg}_lowdim.py``) make it: an agent's ``main``
on a recipe's flags, stopped after its first N segments or updates of the
recipe's schedule, its metrics jsonl wrapped in a header and a summary.

The jsonl at ``out`` holds a header line (event ``header``: the card's
name and power limit from ``nvidia-smi``, torch and CUDA versions, the
script, the argv and N), then the run's own events (one ``train`` line
per eval), then a ``summary`` line (:func:`summarize`: best and final
eval, where the best was, the first eval at or above the gate, wall
seconds, seconds per segment or update, the kernel launches of the run,
the last evals' ``double_reset_frac`` and whether the run ``flatlined``;
where asked, the best eval at the reference runs' eval points, on which
the gate is then scored, and fields of the last ``train`` event).
Each line is also printed to stdout.  A watchdog turns a hang into a
traceback and a nonzero exit.  Without CUDA, and without ``--device cpu``
among the flags, it fails before training (the port never falls back to
the CPU).  On the card a run given the kernels it must launch fails
(exit 1, after its summary) when it launched any other, or missed one.
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

from cartpoleplusplus_tpu_torch import kernels

# The round-5 flatline of the JAX package's two-camera raster A/B
# (runs/ddpg_ab_2cam_raster.jsonl): after FLAT_AFTER segments every eval at
# most FLAT_EVAL and double_reset_frac at least FLAT_DOUBLE_RESET.
FLAT_AFTER, FLAT_EVAL, FLAT_DOUBLE_RESET = 500, 10.0, 0.8
# Evals averaged for the summary's double_reset_frac.
LAST_EVALS = 5


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


def flatlined(trains: list, counter: str = "segment") -> bool | None:
    """The round-5 signature in a run's ``train`` events: every eval after
    ``FLAT_AFTER`` at most ``FLAT_EVAL``, and ``double_reset_frac`` (where
    the run logs it) at least ``FLAT_DOUBLE_RESET`` in each of them; None
    when no eval lies after ``FLAT_AFTER``."""
    late = [e for e in trains if e[counter] > FLAT_AFTER]
    if not late:
        return None
    return all(e["eval_ep_len"] <= FLAT_EVAL
               and e.get("double_reset_frac", FLAT_DOUBLE_RESET) >= FLAT_DOUBLE_RESET
               for e in late)


def summarize(events: list, counter: str, gate: float, seed: int, wall_s: float,
              final: float, launches: dict, ran: int, ref_points: tuple | None = None,
              carry: tuple = ()) -> dict:
    """The summary line of a run's ``events`` (its metrics jsonl):
    ``launches`` the kernels launched during the run (nonzero counts only),
    ``ran`` the segments or updates it ran.  ``s_per_<counter>`` is the
    mean between the first and the last eval (evals included), or the wall
    seconds over ``ran`` where there is one eval.  With ``ref_points``
    (the reference runs' own eval points) the summary gains
    ``best_eval_ref``, the best eval at those points (None where the run
    has none), and ``reached_gate`` is scored on it rather than on the
    best of all evals; ``carry`` names fields of the last ``train`` event
    copied into the summary."""
    trains = [e for e in events if e["event"] == "train"]
    lens = [e["eval_ep_len"] for e in trains]
    best = max(lens)
    first_gate = next((e[counter] for e in trains if e["eval_ep_len"] >= gate), None)
    if len(trains) > 1:
        per = ((trains[-1]["elapsed_s"] - trains[0]["elapsed_s"])
               / (trains[-1][counter] - trains[0][counter]))
    else:
        per = wall_s / max(ran, 1)
    drf = [e["double_reset_frac"] for e in trains[-LAST_EVALS:] if "double_reset_frac" in e]
    summary = {"event": "summary", "seed": seed, "wall_s": wall_s, f"s_per_{counter}": per,
               "final_eval": final, "best_eval": best,
               f"best_{counter}": trains[lens.index(best)][counter],
               f"first_{counter}_at_gate": first_gate, "gate": gate,
               "reached_gate": best >= gate,
               "env_steps": trains[-1].get("env_steps"), "launches": launches,
               "double_reset_frac_last": sum(drf) / len(drf) if drf else None,
               "flatlined": flatlined(trains, counter)}
    if ref_points is not None:
        at_ref = [e["eval_ep_len"] for e in trains if e[counter] in ref_points]
        best_ref = max(at_ref, default=None)
        summary.update(ref_points=list(ref_points), best_eval_ref=best_ref,
                       reached_gate=best_ref is not None and best_ref >= gate)
    summary.update({k: trains[-1].get(k) for k in carry})
    return summary


def run(*, script: str, agent_main: Callable, parser, argv: list, stop_at: int, counter: str,
        gate: float, seed: int, out: str, watchdog_s: float,
        expect_kernels: tuple | None = None, ref_points: tuple | None = None,
        carry: tuple = ()) -> int:
    """``agent_main(argv + ["--metrics-jsonl", …], stop_at=stop_at)`` →
    0, the jsonl written to ``out``; 1 without CUDA unless ``argv`` asks for
    the CPU, or on the card when ``expect_kernels`` is given and the run's
    launched kernels are not exactly those.  ``counter``: the name of the
    run's unit in its ``train`` events, "segment" or "update";
    ``ref_points`` and ``carry`` as in :func:`summarize`."""
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
    before = dict(kernels.LAUNCHES)
    t0 = time.monotonic()
    try:
        final = agent_main([*argv, "--metrics-jsonl", train_log], stop_at=stop_at)
    finally:
        faulthandler.cancel_dump_traceback_later()
    wall = time.monotonic() - t0
    launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    with open(train_log) as f:
        events = [json.loads(line) for line in f]
    os.remove(train_log)
    summary = summarize(events, counter, gate, seed, wall, final, launches, stop_at,
                        ref_points, carry)
    ok = True
    if expect_kernels is not None and not on_cpu:
        ok = set(launches) == set(expect_kernels)
        summary.update(expect_kernels=list(expect_kernels), kernels_as_expected=ok)
    with open(out, "w") as f:
        _emit(f, {"event": "header", "nvidia_smi": smi,
                  "device": "cpu" if on_cpu else torch.cuda.get_device_name(0),
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "script": script, "argv": argv, f"{counter}s": stop_at})
        for e in events:
            _emit(f, e)
        _emit(f, summary)
    if not ok:
        print(f"{os.path.basename(script)}: launched {sorted(launches)}, expected "
              f"{sorted(expect_kernels)}", file=sys.stderr)
    return 0 if ok else 1

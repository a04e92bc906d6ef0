#!/usr/bin/env python3
"""The port's first learning run from scratch: the ``ddpg_it3_learn``
recipe of the JAX package (low-dim DDPG, 3 solver iterations, 128 envs,
1500 segments of 25 steps) through ``cartpoleplusplus_tpu_torch``'s
``main`` on one GPU.

    python3 scripts/torch_ddpg_it3.py [--seed 0] [--out runs/torch_ddpg_it3_s0.jsonl]

Writes the metrics jsonl to ``--out``: a header line (event ``header``: the
card's name and power limit from ``nvidia-smi``, torch and CUDA versions,
the argv), then one ``train`` line per eval (every 100 segments), then a
``summary`` line (best and final eval, wall seconds, whether the best eval
reached the JAX run's gate of 190).  Each line is also printed to stdout.
A watchdog turns a hang into a traceback and a nonzero exit after 900 s.
Without CUDA it fails before training (the port never falls back to the
CPU).  The reference run is the JAX package's on a TPU,
``runs/ddpg_it3_s0.jsonl``: 200.0 at segments 1100 and 1300, 194.4 at 1500.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from cartpoleplusplus_tpu_torch.agents import ddpg  # noqa: E402

WATCHDOG_S = 900
GATE = 190.0
RECIPE = """--solver-iters 3 --num-envs 128 --num-eval 64 --eval-freq 100
  --steps-per-segment 25 --batch-size 256 --replay-capacity 131072
  --warmup-steps 40 --num-train-batches 1500 --reward-scale 0.1 --grad-clip 10""".split()


def _emit(f, record: dict) -> None:
    line = json.dumps(record)
    f.write(line + "\n")
    f.flush()
    print(line, flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="metrics jsonl (default runs/torch_ddpg_it3_s<seed>.jsonl)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_ddpg_it3: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    out = args.out or os.path.join("runs", f"torch_ddpg_it3_s{args.seed}.jsonl")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    argv = [*RECIPE, "--seed", str(args.seed)]
    train_log = out + ".train"
    if os.path.exists(train_log):
        os.remove(train_log)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t0 = time.monotonic()
    try:
        final = ddpg.main([*argv, "--metrics-jsonl", train_log])
    finally:
        faulthandler.cancel_dump_traceback_later()
    wall = time.monotonic() - t0
    with open(train_log) as f:
        events = [json.loads(line) for line in f]
    os.remove(train_log)
    trains = [e for e in events if e["event"] == "train"]
    lens = [e["eval_ep_len"] for e in trains]
    with open(out, "w") as f:
        _emit(f, {"event": "header", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "script": "scripts/torch_ddpg_it3.py", "argv": argv})
        for e in events:
            _emit(f, e)
        _emit(f, {"event": "summary", "seed": args.seed, "wall_s": wall, "final_eval": final,
                  "best_eval": max(lens), "best_segment": trains[lens.index(max(lens))]["segment"],
                  "gate": GATE, "reached_gate": max(lens) >= GATE,
                  "env_steps": trains[-1]["env_steps"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The port's first SAC learning run from scratch: the ``sac_lowdim_fix``
recipe of the JAX package (``scripts/chip_queue6.sh``: low-dim SAC, 128
envs, 25 steps a segment, batch 256, replay 131072, warmup 40, reward
scale 0.1, grad clip 10, cosine learning rates over a 5000-segment
schedule, ``--alpha-min 0.02``) through ``cartpoleplusplus_tpu_torch``'s
``sac.main`` on one GPU, stopped after its first ``--segments`` (2000).

    python3 scripts/torch_sac_lowdim.py [--seed 0] [--segments 2000] \
        [--out runs/torch_sac_lowdim_s0.jsonl] [-- extra flags]

Writes the metrics jsonl to ``--out``: a header line (event ``header``: the
card's name and power limit from ``nvidia-smi``, torch and CUDA versions,
the argv), then one ``train`` line per eval (every 100 segments), then a
``summary`` line (best and final eval, wall seconds, whether the best eval
reached the gate of 190).  Each line is also printed to stdout.  Flags
after ``--`` are appended to the recipe's (the last of a repeated flag
wins): ``-- --device cpu`` and a toy size run it on the CPU.  A watchdog
turns a hang into a traceback and a nonzero exit after 1800 s.  Without
CUDA, and without ``--device cpu``, it fails before training (the port
never falls back to the CPU).  The reference runs are the JAX package's on
a TPU, ``runs/sac_lowdim_fix_s{0,1,2}.jsonl``: first ≥ 190 at segments
1400, 1500 and 1300, and 200.0, 200.0 and 197.5 at segment 2000.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from cartpoleplusplus_tpu_torch.agents import sac  # noqa: E402

WATCHDOG_S = 1800
GATE = 190.0
SEGMENTS = 2000
RECIPE = """--num-envs 128 --num-eval 64 --eval-freq 100
  --steps-per-segment 25 --batch-size 256 --replay-capacity 131072
  --warmup-steps 40 --num-train-batches 5000
  --reward-scale 0.1 --grad-clip 10 --lr-schedule cosine
  --alpha-min 0.02""".split()


def _emit(f, record: dict) -> None:
    line = json.dumps(record)
    f.write(line + "\n")
    f.flush()
    print(line, flush=True)


def _card() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--segments", type=int, default=SEGMENTS,
                   help="segments to run of the recipe's --num-train-batches schedule")
    p.add_argument("--out", default=None,
                   help="metrics jsonl (default runs/torch_sac_lowdim_s<seed>.jsonl)")
    p.add_argument("extra", nargs="*", help="flags appended to the recipe's (after --)")
    args = p.parse_args(argv)
    argv = [*RECIPE, "--seed", str(args.seed), *args.extra]
    on_cpu = sac.make_parser().parse_args(argv).device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        print("torch_sac_lowdim: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    out = args.out or os.path.join("runs", f"torch_sac_lowdim_s{args.seed}.jsonl")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    smi = _card()
    train_log = out + ".train"
    if os.path.exists(train_log):
        os.remove(train_log)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t0 = time.monotonic()
    try:
        final = sac.main([*argv, "--metrics-jsonl", train_log], stop_at=args.segments)
    finally:
        faulthandler.cancel_dump_traceback_later()
    wall = time.monotonic() - t0
    with open(train_log) as f:
        events = [json.loads(line) for line in f]
    os.remove(train_log)
    trains = [e for e in events if e["event"] == "train"]
    lens = [e["eval_ep_len"] for e in trains]
    best = max(lens)
    first_gate = next((e["segment"] for e in trains if e["eval_ep_len"] >= GATE), None)
    with open(out, "w") as f:
        _emit(f, {"event": "header", "nvidia_smi": smi,
                  "device": "cpu" if on_cpu else torch.cuda.get_device_name(0),
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "script": "scripts/torch_sac_lowdim.py", "argv": argv,
                  "segments": args.segments})
        for e in events:
            _emit(f, e)
        _emit(f, {"event": "summary", "seed": args.seed, "wall_s": wall, "final_eval": final,
                  "best_eval": best, "best_segment": trains[lens.index(best)]["segment"],
                  "first_segment_at_gate": first_gate, "gate": GATE,
                  "reached_gate": best >= GATE, "env_steps": trains[-1]["env_steps"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Seconds per DDPG training segment of the port on 1, 2 and 4 cards, on a
host with four:

    python3 scripts/torch_parallel_scaling.py --out scaling.json

``ddpg.main`` at config 5 with the TD3 recipe's flags (chip_smoke.py's
``ddpg_cli`` argv) and 4096 envs, replay 8192 and batch 128 per card, on N
ranks of one card each: ``--num-devices N`` for N > 1 (the backend rule
picks NCCL, each rank on a card of its own), and for N = 1 a 1-rank NCCL
group in this process (the plain segment byte for byte, timed the same
way).  Each rank reports its seconds per segment (``PARALLEL`` lines);
the first segment of a process is its warm-up and is left out of the
mean.  Prints one JSON line per N (the card's name and power limit, each
rank's backend, device and seconds per segment, the mean, and the job's
env steps per second) and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cartpoleplusplus_tpu_torch import parallel  # noqa: E402
from cartpoleplusplus_tpu_torch.agents import ddpg  # noqa: E402
from cartpoleplusplus_tpu_torch.parallel import distributed  # noqa: E402
from cartpoleplusplus_tpu_torch.parallel.mesh import free_port  # noqa: E402

ENVS, REPLAY, BATCH, STEPS = 4096, 8192, 128, 20
FLAGS = ("--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2 --warmup-steps 1 "
         f"--steps-per-segment {STEPS} --num-eval 64 --max-episode-len 50 --twin-critic "
         "--policy-delay 2 --target-noise 0.2 --aug-shift 2 --pixel-encoder conv").split()


def run(n: int, segments: int) -> dict:
    argv = [*FLAGS, "--num-envs", str(ENVS * n), "--replay-capacity", str(REPLAY * n),
            "--batch-size", str(BATCH * n), "--num-devices", str(n),
            "--num-train-batches", str(segments), "--eval-freq", str(segments)]
    if n > 1:
        ddpg.main(argv)
        reports = distributed.LAST_REPORTS
    else:
        distributed.RANK_STATS["segment_s"].clear()
        mesh = parallel.init_process_group(f"localhost:{free_port()}", 0, 1, device="cuda")
        try:
            ddpg.main(argv)
        finally:
            parallel.destroy()
        reports = [{"rank": 0, "backend": mesh.backend, "device": str(mesh.device),
                    "segment_s": list(distributed.RANK_STATS["segment_s"])}]
    later = [s for r in reports for s in r["segment_s"][1:]]
    mean = sum(later) / len(later)
    return {"cards": n, "envs": ENVS * n, "steps_per_segment": STEPS,
            "ranks": [{k: r[k] for k in ("rank", "backend", "device", "segment_s")}
                      for r in reports],
            "mean_segment_s": mean, "env_steps_per_s": ENVS * n * STEPS / mean}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--segments", type=int, default=4)
    parser.add_argument("--cards", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()
    rows = []
    for n in args.cards:
        if n > torch.cuda.device_count():
            continue
        row = {"card": card[0], "cards_visible": torch.cuda.device_count(), **run(n, args.segments)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch.agents import sac  # noqa: E402
from cartpoleplusplus_tpu_torch.utils import learning_run  # noqa: E402

WATCHDOG_S = 1800
GATE = 190.0
SEGMENTS = 2000
RECIPE = """--num-envs 128 --num-eval 64 --eval-freq 100
  --steps-per-segment 25 --batch-size 256 --replay-capacity 131072
  --warmup-steps 40 --num-train-batches 5000
  --reward-scale 0.1 --grad-clip 10 --lr-schedule cosine
  --alpha-min 0.02""".split()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--segments", type=int, default=SEGMENTS,
                   help="segments to run of the recipe's --num-train-batches schedule")
    p.add_argument("--out", default=None,
                   help="metrics jsonl (default runs/torch_sac_lowdim_s<seed>.jsonl)")
    p.add_argument("extra", nargs="*", help="flags appended to the recipe's (after --)")
    args = p.parse_args(argv)
    return learning_run.run(
        script="scripts/torch_sac_lowdim.py", agent_main=sac.main, parser=sac.make_parser(),
        argv=[*RECIPE, "--seed", str(args.seed), *args.extra], stop_at=args.segments,
        counter="segment", gate=GATE, seed=args.seed, watchdog_s=WATCHDOG_S,
        out=args.out or os.path.join("runs", f"torch_sac_lowdim_s{args.seed}.jsonl"))


if __name__ == "__main__":
    sys.exit(main())

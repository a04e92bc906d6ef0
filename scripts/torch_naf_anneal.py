#!/usr/bin/env python3
"""The port's NAF learning run from scratch: the ``naf_anneal`` recipe of the
JAX package (``scripts/sweep.sh``'s NAF loop: low-dim, 128 envs, 25 steps a
segment, batch 256, replay 131072, warmup 40, learning rate 3e-4 with a
cosine decay over 5000 segments, reward scale 0.1, grad clip 10, OU σ
annealed to 0.05 over 100000 steps, no batch norm) through
``cartpoleplusplus_tpu_torch``'s ``naf.main`` on one GPU, stopped after its
first ``--segments`` (2000), with a greedy eval of 64 envs every 100
segments.

    python3 scripts/torch_naf_anneal.py [--seed 0] [--segments 2000] \
        [--out runs/torch_naf_anneal_s0.jsonl] [-- extra flags]

Writes the metrics jsonl to ``--out``: a header line (event ``header``: the
card's name and power limit from ``nvidia-smi``, torch and CUDA versions,
the argv), then one ``train`` line per eval, then a ``summary`` line (best
and final eval, wall seconds, whether the best eval reached the gate of
190).  Each line is also printed to stdout.  Flags after ``--`` are
appended to the recipe's (the last of a repeated flag wins): ``-- --device
cpu`` and a toy size run it on the CPU.  A watchdog turns a hang into a
traceback and a nonzero exit after 1800 s.  Without CUDA, and without
``--device cpu``, it fails before training (the port never falls back to
the CPU).  The reference runs are the JAX package's,
``runs/naf_anneal_s{0,1,2}.jsonl`` (evals every 200 segments): first at or
above 190 at segments 2000, 2000 and 1600, reading 200.0, 198.5 and 199.8
at segment 2000.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch.agents import naf  # noqa: E402
from cartpoleplusplus_tpu_torch.utils import learning_run  # noqa: E402

WATCHDOG_S = 1800
GATE = 190.0
SEGMENTS = 2000
RECIPE = """--num-envs 128 --num-eval 64 --eval-freq 100
  --steps-per-segment 25 --batch-size 256 --replay-capacity 131072
  --warmup-steps 40 --num-train-batches 5000
  --learning-rate 3e-4 --lr-schedule cosine --reward-scale 0.1 --grad-clip 10
  --ou-sigma-min 0.05 --ou-decay-steps 100000""".split()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--segments", type=int, default=SEGMENTS,
                   help="segments to run of the recipe's --num-train-batches schedule")
    p.add_argument("--out", default=None,
                   help="metrics jsonl (default runs/torch_naf_anneal_s<seed>.jsonl)")
    p.add_argument("extra", nargs="*", help="flags appended to the recipe's (after --)")
    args = p.parse_args(argv)
    return learning_run.run(
        script="scripts/torch_naf_anneal.py", agent_main=naf.main, parser=naf.make_parser(),
        argv=[*RECIPE, "--seed", str(args.seed), *args.extra], stop_at=args.segments,
        counter="segment", gate=GATE, seed=args.seed, watchdog_s=WATCHDOG_S,
        out=args.out or os.path.join("runs", f"torch_naf_anneal_s{args.seed}.jsonl"))


if __name__ == "__main__":
    sys.exit(main())

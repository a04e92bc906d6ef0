#!/usr/bin/env python3
"""The port's PPO learning run from scratch: the JAX package's low-dim PPO
recipe (``scripts/chip_queue6.sh``, section 5: 128 envs, 128 rollout
steps, 4 epochs × 8 minibatches, learning rate 3e-4 on a cosine schedule
over 600 updates, reward scale 0.1, grad clip 0.5, 64 eval envs, an eval
every 25 updates) through ``cartpoleplusplus_tpu_torch``'s ``ppo.main`` on
one GPU, stopped after its first ``--updates`` (300).

    python3 scripts/torch_ppo_lowdim.py [--seed 0] [--updates 300] \\
        [--out runs/torch_ppo_lowdim_s0.jsonl] [-- extra flags]

Writes the metrics jsonl to ``--out`` (``utils/learning_run.py``: a
header with the card's name and power limit, one ``train`` line per eval,
a summary with the best eval and whether it reached the gate of 180).
Flags after ``--`` are appended to the recipe's (the last of a repeated
flag wins): ``-- --device cpu`` and a toy size run it on the CPU.  A
watchdog turns a hang into a traceback and a nonzero exit after 1200 s.
The reference runs are the JAX package's on a TPU,
``runs/ppo_lowdim_s{0,1,2}.jsonl``: first ≥ 180 at updates 100, 125 and
100, and 187.6, 196.4 and 183.6 at update 300.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch.agents import ppo  # noqa: E402
from cartpoleplusplus_tpu_torch.utils import learning_run  # noqa: E402

WATCHDOG_S = 1200
GATE = 180.0
UPDATES = 300
RECIPE = """--num-envs 128 --num-eval 64 --eval-freq 25
  --rollout-steps 128 --ppo-epochs 4 --ppo-minibatches 8
  --learning-rate 3e-4 --lr-schedule cosine
  --reward-scale 0.1 --grad-clip 0.5
  --num-train-batches 600""".split()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--updates", type=int, default=UPDATES,
                   help="updates to run of the recipe's --num-train-batches schedule")
    p.add_argument("--out", default=None,
                   help="metrics jsonl (default runs/torch_ppo_lowdim_s<seed>.jsonl)")
    p.add_argument("extra", nargs="*", help="flags appended to the recipe's (after --)")
    args = p.parse_args(argv)
    return learning_run.run(
        script="scripts/torch_ppo_lowdim.py", agent_main=ppo.main, parser=ppo.make_parser(),
        argv=[*RECIPE, "--seed", str(args.seed), *args.extra], stop_at=args.updates,
        counter="update", gate=GATE, seed=args.seed, watchdog_s=WATCHDOG_S,
        out=args.out or os.path.join("runs", f"torch_ppo_lowdim_s{args.seed}.jsonl"))


if __name__ == "__main__":
    sys.exit(main())

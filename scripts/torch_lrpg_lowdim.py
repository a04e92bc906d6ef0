#!/usr/bin/env python3
"""The port's LRPG learning run from scratch: the shape of the JAX
package's low-dim LRPG run ``runs/lrpg_big.jsonl`` (512 envs and 64 eval
envs, read off its logged means since the log records no argv; 6000
updates; the parser's defaults otherwise: learning rate 1e-3, hidden
[100, 50], γ 0.99, 200-step episodes), an eval every 100 updates, through
``cartpoleplusplus_tpu_torch``'s ``lrpg.main`` on one GPU, stopped after
its first ``--updates`` (1000).

    python3 scripts/torch_lrpg_lowdim.py [--seed 0] [--updates 1000] \\
        [--out runs/torch_lrpg_lowdim_s0.jsonl] [-- extra flags]

Writes the metrics jsonl to ``--out`` (``utils/learning_run.py``: a
header with the card's name and power limit, one ``train`` line per eval,
a summary with the best eval and whether it reached the gate of 150).
Flags after ``--`` are appended to the recipe's (the last of a repeated
flag wins): ``-- --device cpu`` and a toy size run it on the CPU.  A
watchdog turns a hang into a traceback and a nonzero exit after 1800 s.
The reference run is the JAX package's on a TPU: 173.7 at update 1000,
its first eval.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch.agents import lrpg  # noqa: E402
from cartpoleplusplus_tpu_torch.utils import learning_run  # noqa: E402

WATCHDOG_S = 1800
GATE = 150.0
UPDATES = 1000
RECIPE = "--num-envs 512 --num-eval 64 --eval-freq 100 --num-train-batches 6000".split()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--updates", type=int, default=UPDATES,
                   help="updates to run of the recipe's --num-train-batches")
    p.add_argument("--out", default=None,
                   help="metrics jsonl (default runs/torch_lrpg_lowdim_s<seed>.jsonl)")
    p.add_argument("extra", nargs="*", help="flags appended to the recipe's (after --)")
    args = p.parse_args(argv)
    return learning_run.run(
        script="scripts/torch_lrpg_lowdim.py", agent_main=lrpg.main, parser=lrpg.make_parser(),
        argv=[*RECIPE, "--seed", str(args.seed), *args.extra], stop_at=args.updates,
        counter="update", gate=GATE, seed=args.seed, watchdog_s=WATCHDOG_S,
        out=args.out or os.path.join("runs", f"torch_lrpg_lowdim_s{args.seed}.jsonl"))


if __name__ == "__main__":
    sys.exit(main())

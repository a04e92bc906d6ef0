#!/usr/bin/env python3
"""The port's pixel TD3 learning run from scratch: the ``ab2k`` recipe of the
JAX package (``scripts/chip_queue6.sh``, section 12: pixel TD3 with the conv
encoder at config 5's render shape, 2 cameras, ``--obs-pool 2``,
``--obs-samples 2``, 512 envs, 25 steps a segment, batch 256, replay 65536,
cosine learning rates over 2000 segments, a greedy eval of 64 envs every 100
segments) through ``cartpoleplusplus_tpu_torch``'s ``ddpg.main`` on one GPU,
stopped after its first ``--segments`` (2000, the whole schedule).

    python3 scripts/torch_ddpg_pixels_ab2k.py [--backend slab|raster] [--seed 0] \
        [--segments 2000] [--out runs/torch_ddpg_pixels_ab2k_<backend>_s<seed>.jsonl] \
        [-- extra flags]

``--backend slab`` renders with the slab cascade (K3/K4), ``raster`` with
the projective raster (K5a), as the JAX script's ``--no-render-raster`` and
``--render-raster``.  Writes the metrics jsonl to ``--out``: a header line
(the card's name and power limit from ``nvidia-smi``, torch and CUDA
versions, the argv), one ``train`` line per eval, then a ``summary`` line
(``utils/learning_run.summarize``: best and final eval, seconds per
segment, the kernel launches, the last evals' ``double_reset_frac``,
``flatlined``, and whether the best eval reached the gate of 45, the lower
of the two JAX slab seeds' bests within 2000 segments, rounded down).
Each line is also printed to stdout.  On the card the run fails (exit 1,
after its summary) unless it launched exactly its backend's kernels: K1,
K2, K3 and K4 for slab; K1, K2 and K5a (through K3's and K4's launches)
for raster.  Flags after ``--`` are appended to the recipe's (the last of
a repeated flag wins): ``-- --device cpu`` and a toy size run it on the
CPU.  A watchdog turns a hang into a traceback and a nonzero exit after
1100 s, inside a 1200 s chip call.  Without CUDA, and without ``--device
cpu``, it fails before training (the port never falls back to the CPU).

The reference runs are the JAX package's on a TPU,
``runs/ddpg_ab2k_{slab,raster}_s{1,2}.jsonl``: best evals within 2000
segments 50.9 and 45.3 (slab), 58.0 and 67.1 (raster).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch.agents import ddpg  # noqa: E402
from cartpoleplusplus_tpu_torch.utils import learning_run  # noqa: E402

WATCHDOG_S = 1100
GATE = 45.0
SEGMENTS = 2000
# scripts/chip_queue6.sh:210-221, flag for flag, less its --seed and
# --metrics-jsonl and the backend's flag.
RECIPE = """--use-raw-pixels --num-cameras 2 --obs-pool 2 --obs-samples 2
  --pixel-encoder conv
  --num-envs 512 --num-eval 64 --eval-freq 100
  --steps-per-segment 25 --batch-size 256 --replay-capacity 65536
  --warmup-steps 40 --num-train-batches 2000
  --actor-learning-rate 1e-4 --critic-learning-rate 3e-4 --lr-schedule cosine
  --reward-scale 0.1 --grad-clip 10 --aug-shift 2
  --ou-sigma-min 0.05 --ou-decay-steps 250000
  --twin-critic --policy-delay 2 --target-noise 0.2
  --pallas-render""".split()
BACKEND_FLAG = {"slab": "--no-render-raster", "raster": "--render-raster"}
_PHYS = ("step_repeats", "step_substeps")
KERNELS = {"slab": (*_PHYS, "render_repeats", "render_batched"),
           "raster": (*_PHYS, "render_repeats_raster", "render_batched_raster")}


def recipe(backend: str, seed: int, extra=()) -> list:
    """The run's ``ddpg`` argv: the recipe, the backend's flag, the seed and
    ``extra``."""
    return [*RECIPE, BACKEND_FLAG[backend], "--seed", str(seed), *extra]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", choices=tuple(BACKEND_FLAG), default="slab")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--segments", type=int, default=SEGMENTS,
                   help="segments to run of the recipe's --num-train-batches schedule")
    p.add_argument("--out", default=None, help="metrics jsonl (default "
                   "runs/torch_ddpg_pixels_ab2k_<backend>_s<seed>.jsonl)")
    p.add_argument("extra", nargs="*", help="flags appended to the recipe's (after --)")
    args = p.parse_args(argv)
    out = args.out or os.path.join(
        "runs", f"torch_ddpg_pixels_ab2k_{args.backend}_s{args.seed}.jsonl")
    return learning_run.run(
        script="scripts/torch_ddpg_pixels_ab2k.py", agent_main=ddpg.main,
        parser=ddpg.make_parser(), argv=recipe(args.backend, args.seed, args.extra),
        stop_at=args.segments, counter="segment", gate=GATE, seed=args.seed,
        watchdog_s=WATCHDOG_S, out=out, expect_kernels=KERNELS[args.backend])


if __name__ == "__main__":
    sys.exit(main())

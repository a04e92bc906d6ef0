#!/usr/bin/env python3
"""The port's pixel SAC learning run from scratch: the JAX package's
``sac_pixels`` recipe (``scripts/chip_queue6.sh:230-239``, and ``:169-178``
for seed 1: SAC with the conv encoder, 2 cameras, ``--obs-pool 2``, 512
envs, 25 steps a segment, batch 256, replay 65536, cosine learning rates
over 15000 segments, DrQ shift 2, the temperature floored at 0.02) through
``cartpoleplusplus_tpu_torch``'s ``sac.main`` on one GPU, stopped after its
first ``--segments`` (N, below).

    python3 scripts/torch_sac_pixels.py [--backend raster|slab] [--seed 0] \
        [--segments N] [--out runs/torch_sac_pixels_<backend>_s<seed>.jsonl] \
        [-- extra flags]

``--backend raster`` is the recipe as it stands: with ``obs_samples`` 0 the
port picks the projective raster (``render.prefer_raster``), so the run
launches K1, K2 and K5a (through K3's and K4's launches).  ``--backend
slab`` appends ``--obs-samples 2``, which is config 5, whose backend is the
slab cascade: K1, K2, K3 and K4.  The JAX package's config-5 SAC run
(``runs/sac_cfg5_s0.jsonl``) kept its flags only in BASELINE.md's prose
("the pixel-SAC recipe at the literal production config"): no script
holds them and its checkpoints hold none, so ``slab`` is the recipe plus
config 5's one difference from the two-camera exact config.

Three cuts of the recipe, each pinned by ``tests/test_torch_sac_pixel_learning.py``:

1. ``--eval-freq 100`` for the recipe's 500.  Evals draw from their own
   generator (seeded from ``--seed`` + 1), so the eval frequency does not
   change the training stream.
2. No ``--ckpt-dir``, ``--ckpt-freq`` or ``--ckpt-skip-replay``: a run with
   a checkpoint directory writes ``ckpt_<segment>`` at its end, and the
   recipe's directory holds the JAX package's own checkpoints.
3. ``stop_at`` = ``--segments``, the cosine schedule kept at its full
   15000 segments (``sac.train``'s ``stop_at`` keeps the schedule's length).

Writes the metrics jsonl to ``--out``: a header line (the card's name and
power limit from ``nvidia-smi``, torch and CUDA versions, the argv), one
``train`` line per eval, then a ``summary`` line
(``utils/learning_run.summarize``: best and final eval, seconds per
segment, the kernel launches, the last evals' ``double_reset_frac``,
``flatlined``, the last eval's ``alpha`` and ``entropy``, and
``best_eval_ref``, the best eval at the JAX runs' own eval points, the
multiples of 500, on which ``reached_gate`` is scored).  The gate is the
lowest best among the four JAX runs below over their evals at or before N,
rounded down: 65 at N = 1000, 128 at N = 1500.  Each line is also printed
to stdout.  On the card the run fails (exit 1, after its summary) unless
it launched exactly its backend's kernels.  Flags after ``--`` are appended
to the recipe's (the last of a repeated flag wins): ``-- --device cpu`` and
a toy size run it on the CPU.  A watchdog turns a hang into a traceback and
a nonzero exit after 1100 s, inside a 1200 s chip call.  Without CUDA, and
without ``--device cpu``, it fails before training (the port never falls
back to the CPU).

The reference runs are the JAX package's on a TPU, evaluated every 500
segments: ``runs/sac_pixels_fix_s0.jsonl``, ``runs/sac_pixels_s1.jsonl``
and ``runs/sac_pixels_fix_s2.jsonl`` (the two-camera exact config, seeds
0-2) and ``runs/sac_cfg5_s0.jsonl`` (config 5, seed 0).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch.agents import sac  # noqa: E402
from cartpoleplusplus_tpu_torch.utils import learning_run  # noqa: E402

WATCHDOG_S = 1100
SEGMENTS = 1000
# The lowest best of the four JAX runs over their evals at or before N,
# rounded down, by N.
GATES = {1000: 65.0, 1500: 128.0}
GATE = GATES[SEGMENTS]
# The JAX runs' eval points (--eval-freq 500) within N.
REF_POINTS = tuple(range(500, SEGMENTS + 1, 500))
CARRY = ("alpha", "entropy")
# scripts/chip_queue6.sh:231-237, flag for flag, less its --ckpt-* flags,
# with --eval-freq 100 for 500.
RECIPE = """--use-raw-pixels --num-cameras 2 --obs-pool 2 --pixel-encoder conv
  --num-envs 512 --num-eval 64 --eval-freq 100
  --steps-per-segment 25 --batch-size 256 --replay-capacity 65536
  --warmup-steps 40 --num-train-batches 15000
  --actor-learning-rate 1e-4 --critic-learning-rate 3e-4 --lr-schedule cosine
  --reward-scale 0.1 --grad-clip 10 --aug-shift 2 --alpha-min 0.02
  --pallas-render""".split()
BACKEND_FLAGS = {"raster": [], "slab": ["--obs-samples", "2"]}
_PHYS = ("step_repeats", "step_substeps")
KERNELS = {"slab": (*_PHYS, "render_repeats", "render_batched"),
           "raster": (*_PHYS, "render_repeats_raster", "render_batched_raster")}


def recipe(backend: str, seed: int, extra=()) -> list:
    """The run's ``sac`` argv: the recipe, the backend's flags, the seed and
    ``extra``."""
    return [*RECIPE, *BACKEND_FLAGS[backend], "--seed", str(seed), *extra]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", choices=tuple(BACKEND_FLAGS), default="raster")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--segments", type=int, default=SEGMENTS,
                   help="segments to run of the recipe's --num-train-batches schedule")
    p.add_argument("--out", default=None, help="metrics jsonl (default "
                   "runs/torch_sac_pixels_<backend>_s<seed>.jsonl)")
    p.add_argument("extra", nargs="*", help="flags appended to the recipe's (after --)")
    args = p.parse_args(argv)
    out = args.out or os.path.join("runs", f"torch_sac_pixels_{args.backend}_s{args.seed}.jsonl")
    return learning_run.run(
        script="scripts/torch_sac_pixels.py", agent_main=sac.main, parser=sac.make_parser(),
        argv=recipe(args.backend, args.seed, args.extra), stop_at=args.segments,
        counter="segment", gate=GATE, seed=args.seed, watchdog_s=WATCHDOG_S, out=out,
        expect_kernels=KERNELS[args.backend], ref_points=REF_POINTS, carry=CARRY)


if __name__ == "__main__":
    sys.exit(main())

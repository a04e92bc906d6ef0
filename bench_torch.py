#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one NVIDIA GPU: batched env steps/s.

Thin wrapper over cartpoleplusplus_tpu_torch.utils.benchmark, the port's
counterpart of bench.py.  Measures the training loop (sim + per-repeat
render through the port's CUDA kernels, actor, replay write, DDPG update)
on the card.  Streams one JSON line per completed row of the suite (config
5, 1cam_exact, 1cam_samples1, lowdim), then the summary line last:
{"metric", "value", "unit", "vs_baseline", "vs_ceiling", "north_star",
"rows"}.  Without a card it prints one {"error": ...} line and exits
non-zero.

vs_baseline = value / 1e7, BASELINE.json's stated target.  Each row's
``ceiling`` is the card's float32 mix rate, measured in the row's process
by the op-rate probe (K6), over the config's census ops per env step.

    python3 bench_torch.py                       # the suite
    python3 bench_torch.py --single --lowdim --num-envs 8192
    python3 bench_torch.py --device cpu --single --num-envs 16 ...   # plain versions
"""

import sys

from cartpoleplusplus_tpu_torch.utils.benchmark import main

if __name__ == "__main__":
    sys.exit(main())

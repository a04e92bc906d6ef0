#!/usr/bin/env python3
"""``chip_smoke.py``'s ``parallel`` phase alone, to iterate on it without the
other phases, on a host with one card:

    python3 scripts/chip_smoke_parallel.py > parallel.out 2> parallel.err

Builds the kernels, runs ``chip_smoke.parallel_check`` (``ddpg_cli``'s
segment time, which it prints beside its own, is not measured here: 0) and
prints the card, the phase's seconds, its line and its checks; exits 1 when
a check is false.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from cartpoleplusplus_tpu_torch import kernels  # noqa: E402


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kernels.build()
    kernels.library()
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    t = time.monotonic()
    try:
        line, _ = chip_smoke.parallel_check(work, torch.device("cuda"), 0.0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("phase_s", time.monotonic() - t, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps(line["checks"]), flush=True)
    return 0 if all(line["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())

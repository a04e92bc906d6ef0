#!/usr/bin/env python3
"""The pixel-TD3 ``ab2k`` runs side by side: for each metrics jsonl under
``runs/`` (the JAX package's ``ddpg_ab2k_*`` on a TPU, the port's
``torch_ddpg_pixels_ab2k_*`` on a GPU), one markdown row of its best eval
within 1000, 1500 and 2000 segments, the first segment at or above 45, the
eval at segment 100, the range of ``double_reset_frac`` over its last 5
evals, whether it flatlined (``utils/learning_run.flatlined``), and, for
the port's, the card, seconds per segment and the kernels launched.

    python3 scripts/ab2k_table.py [runs/…jsonl …]
"""

from __future__ import annotations

import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch.utils import learning_run  # noqa: E402

CUTS = (1000, 1500, 2000)
GATE = 45.0


def row(path: str) -> str:
    with open(path) as f:
        events = [json.loads(line) for line in f]
    trains = [e for e in events if e["event"] == "train"]
    head = next((e for e in events if e["event"] == "header"), {})
    summary = next((e for e in events if e["event"] == "summary"), {})
    bests = [max((e["eval_ep_len"] for e in trains if e["segment"] <= c), default=None)
             for c in CUTS]
    first = next((e["segment"] for e in trains if e["eval_ep_len"] >= GATE), None)
    at100 = next((e["eval_ep_len"] for e in trains if e["segment"] == 100), None)
    drf = [e["double_reset_frac"] for e in trains[-5:]]
    cells = [os.path.basename(path), *(f"{b:.2f}" for b in bests), str(first),
             f"{at100:.2f}", f"{min(drf):.3f}-{max(drf):.3f}",
             str(learning_run.flatlined(trains)).lower(),
             head.get("nvidia_smi") or "TPU (JAX)",
             f"{summary['s_per_segment']:.3f}" if "s_per_segment" in summary else "",
             ", ".join(sorted(summary.get("launches", {})))]
    return "| " + " | ".join(cells) + " |"


def main(argv=None) -> int:
    paths = (argv if argv else sys.argv[1:]) or sorted(
        glob.glob("runs/ddpg_ab2k_*.jsonl") + glob.glob("runs/torch_ddpg_pixels_ab2k_*.jsonl"))
    print("| run | best ≤1000 | ≤1500 | ≤2000 | first ≥ 45 | eval at 100 | "
          "double_reset_frac, last 5 | flatlined | card | s/segment | kernels |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for p in paths:
        print(row(p))
    return 0


if __name__ == "__main__":
    sys.exit(main())

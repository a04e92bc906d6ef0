#!/usr/bin/env python3
"""The pixel learning runs side by side: for each metrics jsonl matched by
the run globs (by default the JAX package's ``runs/ddpg_ab2k_*`` on a TPU
and the port's ``runs/torch_ddpg_pixels_ab2k_*`` on a GPU), one markdown
row of its best eval within each of ``--cuts`` segments, the first segment
at or above ``--gate``, the eval at each of ``--at``'s segments (empty
where the run has none), the range of ``double_reset_frac`` over its last
5 evals, whether it flatlined (``utils/learning_run.flatlined``), and, for
the port's, the card, seconds per segment and the kernels launched.

    python3 scripts/ab2k_table.py [--cuts 1000,1500,2000] [--gate 45] [--at 100] \
        [--ref-points 500,1000] [--last alpha,entropy] [--horizon N] [glob …]

``--horizon N`` reads each run's evals up to segment N only (every column
then describes the first N segments); ``--ref-points`` adds the best eval
at those segments and whether it reached the gate (the pixel SAC runs'
``best_eval_ref``); ``--last`` adds those fields of the last eval read.
With no option the table is the pixel-TD3 ``ab2k`` one; the pixel SAC
runs' is

    python3 scripts/ab2k_table.py --cuts 500,1000 --gate 65 --at 100,500,1000 \
        --ref-points 500,1000 --last alpha,entropy --horizon 1000 \
        'runs/sac_pixels_fix_s*.jsonl' runs/sac_pixels_s1.jsonl \
        runs/sac_cfg5_s0.jsonl 'runs/torch_sac_pixels_*.jsonl'
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch.utils import learning_run  # noqa: E402

RUNS = ("runs/ddpg_ab2k_*.jsonl", "runs/torch_ddpg_pixels_ab2k_*.jsonl")
CUTS = (1000, 1500, 2000)
GATE = 45.0
AT = (100,)


def _ints(text: str) -> tuple:
    return tuple(int(x) for x in text.split(",") if x)


def _eval(x) -> str:
    return "" if x is None else f"{x:.2f}"


def row(path: str, cuts=CUTS, gate=GATE, at=AT, ref_points=(), last=(),
        horizon: int | None = None) -> str:
    with open(path) as f:
        events = [json.loads(line) for line in f]
    trains = [e for e in events if e["event"] == "train"
              and (horizon is None or e["segment"] <= horizon)]
    head = next((e for e in events if e["event"] == "header"), {})
    summary = next((e for e in events if e["event"] == "summary"), {})
    evals = {e["segment"]: e["eval_ep_len"] for e in trains}
    bests = [max((e["eval_ep_len"] for e in trains if e["segment"] <= c), default=None)
             for c in cuts]
    first = next((e["segment"] for e in trains if e["eval_ep_len"] >= gate), None)
    drf = [e["double_reset_frac"] for e in trains[-5:]]
    cells = [os.path.basename(path), *(_eval(b) for b in bests), str(first),
             *(_eval(evals.get(s)) for s in at)]
    if ref_points:
        best_ref = max((evals[s] for s in ref_points if s in evals), default=None)
        cells += [_eval(best_ref), str(best_ref is not None and best_ref >= gate).lower()]
    cells += [f"{min(drf):.3f}-{max(drf):.3f}", str(learning_run.flatlined(trains)).lower(),
              *(f"{trains[-1][k]:.3f}" if k in trains[-1] else "" for k in last),
              head.get("nvidia_smi") or "TPU (JAX)",
              f"{summary['s_per_segment']:.3f}" if "s_per_segment" in summary else "",
              ", ".join(sorted(summary.get("launches", {})))]
    return "| " + " | ".join(cells) + " |"


def header(cuts=CUTS, gate=GATE, at=AT, ref_points=(), last=()) -> list:
    names = ["run", f"best ≤{cuts[0]}", *(f"≤{c}" for c in cuts[1:]), f"first ≥ {gate:g}",
             *(f"eval at {s}" for s in at)]
    if ref_points:
        names += [f"best at {', '.join(map(str, ref_points))}", f"≥ {gate:g}"]
    names += ["double_reset_frac, last 5", "flatlined", *(f"{k}, last eval" for k in last),
              "card", "s/segment", "kernels"]
    return ["| " + " | ".join(names) + " |", "|" + "---|" * len(names)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cuts", type=_ints, default=CUTS, help="comma-separated segments")
    p.add_argument("--gate", type=float, default=GATE)
    p.add_argument("--at", type=_ints, default=AT, help="comma-separated segments")
    p.add_argument("--ref-points", type=_ints, default=(), help="comma-separated segments")
    p.add_argument("--last", type=lambda t: tuple(t.split(",")), default=(),
                   help="comma-separated fields of the last eval")
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("runs", nargs="*", default=list(RUNS), help="run globs")
    args = p.parse_args(argv)
    paths = sorted({path for pattern in args.runs for path in glob.glob(pattern)})
    shape = dict(cuts=args.cuts, gate=args.gate, at=args.at, ref_points=args.ref_points,
                 last=args.last)
    print("\n".join(header(**shape)))
    for path in paths:
        print(row(path, horizon=args.horizon, **shape))
    return 0


if __name__ == "__main__":
    sys.exit(main())

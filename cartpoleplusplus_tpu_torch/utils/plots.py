"""Learning-curve plots from metrics jsonl: port of
cartpoleplusplus_tpu.utils.plots.

The agents write one JSON object per event (:class:`utils.metrics.
MetricsLogger`); this CLI turns the ``train`` events of one or more runs,
of either package, into a PNG of one column (default ``eval_ep_len``)
against training progress.  It runs on the host and needs no device;
matplotlib is imported by :func:`main` only.

    python -m cartpoleplusplus_tpu_torch.utils.plots runs/*.jsonl -o curves.png
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_run(path: str) -> dict:
    """JSONL → {column: list} for 'train' events."""
    cols: dict[str, list] = {}
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("event") != "train":
                continue
            for k, v in rec.items():
                cols.setdefault(k, []).append(v)
    return cols


def main(argv=None):
    parser = argparse.ArgumentParser(description="plot cartpole++ learning curves")
    parser.add_argument("jsonl", nargs="+", help="metrics JSONL files")
    parser.add_argument("-o", "--out", default="learning_curves.png")
    parser.add_argument("--x", default=None,
                        help="x column (default: update/segment/env_steps)")
    parser.add_argument("--y", default="eval_ep_len")
    opts = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for path in opts.jsonl:
        cols = load_run(path)
        if not cols:
            print(f"warning: no train events in {path}", file=sys.stderr)
            continue
        xkey = opts.x or next(
            (k for k in ("env_steps", "update", "segment") if k in cols), "elapsed_s"
        )
        if opts.y not in cols:
            print(f"warning: {path} has no column {opts.y!r}", file=sys.stderr)
            continue
        label = os.path.splitext(os.path.basename(path))[0]
        ax.plot(cols[xkey], cols[opts.y], label=label, linewidth=1.5)
    ax.set_xlabel(opts.x or "training progress")
    ax.set_ylabel(opts.y)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(opts.out, dpi=120)
    print(f"wrote {opts.out}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Rounds of two spawned gloo ranks on the CPU, each running the batch-norm
run of ``tests/test_torch_checkpoint_sharded.py`` (two data-parallel DDPG
segments and a global checkpoint) and then leaving its group, counting the
rounds where a rank did not exit 0 with its result (such as the gloo abort,
exit -6 with ``terminate called without an active exception``).

    python3 scripts/torch_teardown_rounds.py [--tree .] [--rounds 100]

``--tree`` is the checkout whose package and tests run (a parent commit
unpacked elsewhere, say).  Run two or more at once, so they load the host
as a full test run does.  Prints a line every 20 rounds and a last line
``{"rounds": N, "failures": {message: count}}``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--rounds", type=int, default=100)
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "tests")]
    import test_torch_checkpoint_sharded as sharded
    from cartpoleplusplus_tpu_torch import parallel
    from cartpoleplusplus_tpu_torch.parallel.distributed import RankFailure

    fails = collections.Counter()
    t0 = time.monotonic()
    for i in range(args.rounds):
        with tempfile.TemporaryDirectory() as d:
            try:
                parallel.run_ranks(2, sharded._batch_norm_run, d, timeout_s=240)
            except RankFailure as e:
                fails[str(e)] += 1
        if (i + 1) % 20 == 0:
            print(json.dumps({"round": i + 1, "failures": dict(fails),
                              "s": round(time.monotonic() - t0, 1)}), flush=True)
    print(json.dumps({"rounds": args.rounds, "failures": dict(fails)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Write the online Q-network of a JAX DQN checkpoint as an npz of its flax leaves.

    python3 scripts/export_dqn_q_npz.py \
        [--ckpt runs/ckpt_dqn_rainbow/ckpt_50000.msgpack] \
        [--out chip_inputs/dqn_rainbow_50000_q.npz]

Reads the checkpoint with the port's pure-Python flax-msgpack reader
(``cartpoleplusplus_tpu_torch.utils.flax_msgpack``: no flax or msgpack
needed) and saves every leaf of ``params`` under its flax path
(``params/ObsEncoder_0/MLPTrunk_0/hidden0/kernel``, …,
``params/advantage/kernel_sigma``, …), float32, compressed.  The card needs
only these weights (12 leaves, ~40 k floats, of the 0.69 MB checkpoint):
``chip_smoke.py``'s ``dqn_crossload`` phase loads them through
``utils.params.q_network_params_from_flax`` and checks the file's sha256.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cartpoleplusplus_tpu_torch.utils import flax_msgpack  # noqa: E402
from cartpoleplusplus_tpu_torch.utils.params import flatten_tree  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", default="runs/ckpt_dqn_rainbow/ckpt_50000.msgpack")
    p.add_argument("--out", default="chip_inputs/dqn_rainbow_50000_q.npz")
    args = p.parse_args(argv)
    leaves = flatten_tree(flax_msgpack.load(args.ckpt)["params"])
    np.savez_compressed(args.out, **{k: np.asarray(v, np.float32) for k, v in leaves.items()})
    with open(args.out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    print(f"{args.out}: {len(leaves)} leaves, {os.path.getsize(args.out)} bytes, "
          f"sha256 {digest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

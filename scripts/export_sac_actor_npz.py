#!/usr/bin/env python3
"""Write the actor of a JAX SAC checkpoint as an npz of its flax leaves.

    python3 scripts/export_sac_actor_npz.py \
        [--ckpt runs/ckpt_sac_cfg5_s0/ckpt_15000.msgpack] \
        [--out chip_inputs/sac_cfg5_15000_actor.npz]

Reads the checkpoint with the port's pure-Python flax-msgpack reader
(``cartpoleplusplus_tpu_torch.utils.flax_msgpack``: no flax or msgpack
needed) and saves every leaf of ``actor_params`` under its flax path
(``params/ObsEncoder_0/ConvTrunk_0/conv0/kernel``, …, ``params/mu/…``,
``params/log_std/…``), float32, compressed.  The card needs only these
weights (~0.29 MB of the 9.1 MB checkpoint): ``chip_smoke.py``'s
``sac_crossload`` phase loads them through
``utils.params.gaussian_actor_params_from_flax`` and checks the file's
sha256.
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
    p.add_argument("--ckpt", default="runs/ckpt_sac_cfg5_s0/ckpt_15000.msgpack")
    p.add_argument("--out", default="chip_inputs/sac_cfg5_15000_actor.npz")
    args = p.parse_args(argv)
    leaves = flatten_tree(flax_msgpack.load(args.ckpt)["actor_params"])
    np.savez_compressed(args.out, **{k: np.asarray(v, np.float32) for k, v in leaves.items()})
    with open(args.out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    print(f"{args.out}: {len(leaves)} leaves, {os.path.getsize(args.out)} bytes, "
          f"sha256 {digest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

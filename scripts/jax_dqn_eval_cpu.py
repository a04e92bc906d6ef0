#!/usr/bin/env python3
"""The JAX package's own greedy eval of the full Rainbow DQN checkpoint, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/jax_dqn_eval_cpu.py \
        [--ckpt runs/ckpt_dqn_rainbow/ckpt_50000.msgpack] [--keys 5] [--num-eval 64] \
        [--out runs/jax_dqn_eval_cpu.jsonl]

Restores the online ``QNetwork`` (dueling, C51 with 51 atoms, NoisyNet
heads) of a checkpoint written by ``python -m cartpoleplusplus_tpu.agents.dqn
--per --n-step 3 --dueling --c51 51 --c51-vmax 10 --noisy``
(``scripts/chip_queue6.sh``, step 2: low-dim, the default config) and runs
``common.eval_rollout`` with ``dqn.greedy_act`` (the noisy heads at their
mu weights) on a ``--num-eval``-env ``make_venv`` of that config under
``jax.random.PRNGKey(k)`` for k in [0, --keys).  Prints one JSON line per
key and a summary line, and writes them to ``--out``: the yardstick the
port's cross-load eval (``chip_smoke.py``'s ``dqn_crossload`` phase) is
held against.  This script is the reference's; it imports JAX and is not
part of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np
from flax import serialization

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from cartpoleplusplus_tpu.agents import common
from cartpoleplusplus_tpu.agents.dqn import greedy_act
from cartpoleplusplus_tpu.env.config import CartpoleConfig
from cartpoleplusplus_tpu.models import QNetwork


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", default="runs/ckpt_dqn_rainbow/ckpt_50000.msgpack")
    p.add_argument("--keys", type=int, default=5)
    p.add_argument("--num-eval", type=int, default=64)
    p.add_argument("--out", default="runs/jax_dqn_eval_cpu.jsonl")
    args = p.parse_args()
    config = CartpoleConfig(discrete_actions=True)
    with open(args.ckpt, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    params = jax.tree.map(np.asarray, raw["params"])
    qnet = QNetwork(num_actions=5, dueling=True, num_atoms=51, noisy=True)
    venv = common.make_venv(config, args.num_eval)
    eval_fn = jax.jit(lambda prm, k: common.eval_rollout(venv, greedy_act(qnet), prm, k))
    lens, rews, lines = [], [], []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    for k in range(args.keys):
        t = time.monotonic()
        elen, erew = eval_fn(params, jax.random.PRNGKey(k))
        lens.append(float(elen))
        rews.append(float(erew))
        emit({"key": k, "eval_ep_len": lens[-1], "eval_ep_rew": rews[-1],
              "seconds": time.monotonic() - t})
    emit({"ckpt": args.ckpt, "num_eval": args.num_eval, "keys": args.keys,
          "use_raw_pixels": config.use_raw_pixels,
          "solver_iterations": config.solver_iterations,
          "eval_ep_len": lens, "mean_len": float(np.mean(lens)),
          "min_len": min(lens), "max_len": max(lens),
          "eval_ep_rew": rews, "mean_rew": float(np.mean(rews))})
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The serving artifact: a greedy policy as a ``torch.export`` program; port
of cartpoleplusplus_tpu.utils.export.

A trained policy ships as one self-contained ``.pt2`` file that a server
loads without the agent's code or this package's networks: the greedy
policy module (``agents/common.GreedyPolicy``) is traced once from a copy
of its weights on the CPU, with

- a **symbolic batch dimension** (``torch.export.Dim``, 1 and up): the
  server picks any batch size at call time without exporting again, and
- the weights inside the file, saved by ``torch.export.save``.

The observation ABI is training's: raw **uint8** frames for pixel policies
(the encoder decodes them), float32 for low-dim ones.  Exported from CPU
weights, an artifact loads on the CPU or on the card, ``load_policy``
moving its weights and the devices named in its graph there::

    from cartpoleplusplus_tpu_torch.utils import export as pe
    policy = pe.load_policy("actor.pt2", "cuda")
    actions = policy(obs_batch)          # any batch size

Every agent CLI writes one with ``--export-policy PATH`` (after training,
or from a checkpoint under ``--eval-only``); this module's CLI inspects
and smoke-runs an artifact::

    python -m cartpoleplusplus_tpu_torch.utils.export --load actor.pt2 --batch 64 \\
        [--steps 100] [--device cpu]

``torch.export`` imports ``torch._dynamo``, several seconds on a card's
host, so this module imports it inside its functions only: nothing that
merely imports an agent pays for it.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time
from typing import Callable, Sequence

import torch

from cartpoleplusplus_tpu_torch import resolve_device


def export_policy(act_module: torch.nn.Module, obs_shape: Sequence[int],
                  obs_dtype: torch.dtype = torch.float32):
    """Trace ``act_module(obs)`` → an ``ExportedProgram`` with a symbolic
    batch dim.  ``act_module`` is copied to the CPU first (its own weights
    stay where they are), so the artifact names no card; ``obs_shape``
    excludes the batch dim."""
    from torch.export import Dim, export

    module = copy.deepcopy(act_module).cpu()
    example = torch.zeros((2, *obs_shape), dtype=obs_dtype)
    return export(module, (example,), dynamic_shapes=({0: Dim("batch", min=1)},))


def save_policy(path: str, act_module: torch.nn.Module, obs_shape: Sequence[int],
                obs_dtype: torch.dtype = torch.float32) -> int:
    """Export and save to ``path`` (a ``.pt2``) → the artifact's bytes."""
    import torch.export

    torch.export.save(export_policy(act_module, obs_shape, obs_dtype), path)
    return os.path.getsize(path)


def load_policy(path: str, device=None) -> Callable:
    """Load an artifact on ``device`` (CUDA unless the caller asks for the
    CPU), its weights and the devices its graph names moved there →
    ``policy(obs_batch) -> actions``; the observations may be a tensor
    anywhere or a numpy array."""
    import torch.export
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    module = move_to_device_pass(torch.export.load(path), dev).module()

    def policy(obs) -> torch.Tensor:
        return module(torch.as_tensor(obs, device=dev))

    return policy


def _spec(node) -> dict:
    val = node.meta["val"]
    return {"name": node.name, "shape": [str(d) for d in val.shape],
            "dtype": str(val.dtype).removeprefix("torch.")}


def describe(path: str) -> dict:
    """The artifact's bytes, its input and output specs (the batch dim as
    its symbol) and the symbol's range, and the observation dtype, without
    running it."""
    import torch.export

    ep = torch.export.load(path)
    sig = ep.graph_signature
    nodes = {n.name: n for n in ep.graph.nodes}
    inputs = [_spec(nodes[name]) for name in sig.user_inputs]
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outputs = [_spec(n) for n in out_node.args[0] if isinstance(n, torch.fx.Node)]
    batch = nodes[sig.user_inputs[0]].meta["val"].shape[0]
    rng = ep.range_constraints.get(batch.node.expr) if isinstance(batch, torch.SymInt) else None
    bound = lambda b: int(b) if b.is_Integer else None  # None: unbounded
    return {
        "bytes": os.path.getsize(path),
        "inputs": inputs,
        "outputs": outputs,
        "dtype": inputs[0]["dtype"],
        "batch": {"symbol": str(batch), "symbolic": isinstance(batch, torch.SymInt),
                  "min": bound(rng.lower) if rng else None,
                  "max": bound(rng.upper) if rng else None},
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Inspect / smoke-run an exported policy artifact")
    parser.add_argument("--load", required=True, help="artifact path")
    parser.add_argument("--batch", type=int, default=8, help="batch size for the smoke run")
    parser.add_argument("--steps", type=int, default=0,
                        help="also time this many repeat calls")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device: CUDA unless 'cpu' is asked for")
    opts = parser.parse_args(argv)
    dev = resolve_device(opts.device)

    meta = describe(opts.load)
    print(f"ARTIFACT {meta}", file=sys.stderr)
    policy = load_policy(opts.load, dev)
    shape = [opts.batch] + [int(d) for d in meta["inputs"][0]["shape"][1:]]
    obs = torch.zeros(shape, dtype=getattr(torch, meta["dtype"]), device=dev)
    out = policy(obs)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    print(f"CALL ok batch={opts.batch} out_shapes={[tuple(o.shape) for o in outs]}",
          file=sys.stderr)
    result = {"meta": meta, "out_shapes": [list(o.shape) for o in outs]}
    if opts.steps > 0:
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        policy(obs)
        sync()
        t0 = time.perf_counter()
        for _ in range(opts.steps):
            out = policy(obs)
        sync()
        dt = time.perf_counter() - t0
        result["ms_per_call"] = dt * 1e3 / opts.steps
        print(f"TIMING {opts.steps} calls x batch {opts.batch}: "
              f"{result['ms_per_call']:.3f} ms/call "
              f"({opts.steps * opts.batch / dt:,.0f} actions/s)", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()

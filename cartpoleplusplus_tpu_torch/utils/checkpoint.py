"""Checkpoint / resume: port of the single-process half of
cartpoleplusplus_tpu.utils.checkpoint.

A checkpoint is a nested dict of tensors and host values (ints, floats,
lists, None): a training state's ``state_dict()``, or any such dict.
``save`` writes ``<ckpt_dir>/ckpt_<step>.pt`` with ``torch.save`` through
a temp file and ``os.replace``, so a file is never half written; every
file loads with ``torch.load(weights_only=True)``.  ``restore_latest``
reproduces the restore-if-present startup: the newest numbered file is
merged into a target leniently (a tensor whose shape or dtype disagrees
keeps the target's fresh value, reported on stderr), so a
``--ckpt-skip-replay`` file restores into a fresh full-size replay.
``ckpt_best.pt`` holds the state at the best eval with its step and eval
embedded in the same file.  The JAX package's msgpack files are not read
here (``utils.params.ddpg_params_from_jax_checkpoint`` carries their
weights across).

Data-parallel runs (``parallel/``): under one launcher rank 0 gathers the
state (``parallel.global_state_dict``) and writes the one global
``ckpt_<step>.pt``, as the JAX ``save`` gathers a mesh's shards; under
``--num-processes`` > 1 every rank writes its own state to
``ckpt_<step>.rank<k>of<n>.pt`` (:func:`save_rank`).  The port's k and n
count ranks, each a process of one device, where the JAX package's count
processes that each hold several chips.  :func:`restore_latest_sharded`
resumes a job from a complete set of rank files or from a global file
sliced per rank; :func:`restore_latest` (one process, ``--eval-only``)
falls back to the newest rank-0 file, whose replicated entries are whole.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import sys
from typing import Any, Optional

import torch

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")
_CKPT_RANK_RE = re.compile(r"^ckpt_(\d+)\.rank(\d+)of(\d+)\.pt$")
_BEST_NAME = "ckpt_best.pt"
_REPLAY_SIG = {"s1", "action", "reward", "s2", "terminal", "cursor", "size"}
_REPLAY_DATA = ("s1", "action", "reward", "s2", "terminal", "priority")
_LOAD_ERRORS = (OSError, RuntimeError, EOFError, pickle.UnpicklingError)


def _as_dict(tree: Any) -> Any:
    """A training state (anything with ``state_dict()``) → its dict."""
    return tree if isinstance(tree, dict) else tree.state_dict()


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def strip_replay(tree: Any) -> Any:
    """Replace every replay sub-dict (the keys of a ``ReplayState``) with an
    empty one: zero-length data tensors of the same dtypes, cursor and size
    0.  The ``--ckpt-skip-replay`` mode: a pixel run's replay is hundreds
    of MB to GB and refills within capacity/num_envs steps on resume;
    cursor and size are zeroed too, or a restore would sample unwritten
    rows.  A prioritized replay's priorities go with its data."""
    if not isinstance(tree, dict):
        return tree
    if _REPLAY_SIG <= set(tree):
        out = dict(tree)
        for k in _REPLAY_DATA:
            if k in tree:
                out[k] = torch.zeros((0,), dtype=tree[k].dtype)
        out["cursor"], out["size"] = 0, 0
        return out
    return {k: strip_replay(v) for k, v in tree.items()}


def _write(path: str, obj: Any) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str, mmap: bool = False) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)


def save(ckpt_dir: str, step: int, tree: Any, skip_replay: bool = False) -> str:
    """Write ``tree`` (a dict or a state with ``state_dict()``) to
    ``<ckpt_dir>/ckpt_<step>.pt``, its tensors copied to the host."""
    os.makedirs(ckpt_dir, exist_ok=True)
    sd = _to_cpu(_as_dict(tree))
    if skip_replay:
        sd = strip_replay(sd)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    _write(path, sd)
    return path


def save_rank(ckpt_dir: str, step: int, tree: Any, rank: int, world: int,
              skip_replay: bool = False) -> str:
    """Write one rank's state (its env and replay shard, its copy of the
    replicated entries, its own generator) to
    ``<ckpt_dir>/ckpt_<step>.rank<rank>of<world>.pt``.  A step restores
    once all ``world`` files exist (:func:`latest_sharded_step`)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    sd = _to_cpu(_as_dict(tree))
    if skip_replay:
        sd = strip_replay(sd)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.rank{rank}of{world}.pt")
    _write(path, sd)
    return path


def save_best(ckpt_dir: str, step: int, eval_len: float, tree: Any,
              skip_replay: bool = False) -> str:
    """Keep the best-eval state as ``ckpt_best.pt``: the state and its
    ``_best_meta`` (step, eval episode length) in one file, replaced
    atomically, so the improvement gate never reads a meta that is not the
    weights'.  A json sidecar (``ckpt_best.pt.json``) is written after it
    for humans; no code reads it.  Callers gate on improvement; this only
    writes."""
    os.makedirs(ckpt_dir, exist_ok=True)
    sd = _to_cpu(_as_dict(tree))
    if skip_replay:
        sd = strip_replay(sd)
    path = os.path.join(ckpt_dir, _BEST_NAME)
    meta = {"step": int(step), "eval_ep_len": float(eval_len)}
    _write(path, {"state": sd, "_best_meta": meta})
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")
    return path


def best_meta(ckpt_dir: Optional[str]) -> Optional[dict]:
    """``{"step", "eval_ep_len"}`` embedded in ``ckpt_best.pt`` (its tensors
    memory-mapped, not read), or None when there is no readable file."""
    path = os.path.join(ckpt_dir or "", _BEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        m = _load(path, mmap=True)["_best_meta"]
    except _LOAD_ERRORS as e:
        print(f"checkpoint {path}: unreadable ({type(e).__name__}); no best eval to beat",
              file=sys.stderr)
        return None
    return {"step": int(m["step"]), "eval_ep_len": float(m["eval_ep_len"])}


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir) if (m := _CKPT_RE.match(name))]
    return max(steps) if steps else None


def load_raw(ckpt_dir: str, step: int) -> Any:
    """Load ``ckpt_<step>.pt`` as saved (nested dicts, CPU tensors)."""
    return _load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"))


def _merge(target: Any, raw: Any, skipped: list, path: str = "") -> Any:
    """``raw``'s tensors where shape and dtype match the target's, the
    target's fresh ones where not (recorded in ``skipped``); host values as
    saved; keys only ``raw`` has (an optimizer's per-parameter state, made
    by its first step) as saved.

    A replay sub-dict merges as a unit: if any of its data tensors is kept
    fresh (a skip-replay file, another capacity or env count), its cursor
    and size keep the target's too, or the train gate would open on
    unwritten rows."""
    if isinstance(target, dict):
        if not isinstance(raw, dict):
            skipped.append(f"{path} (not a dict)")
            return target
        local: list = []
        out = {}
        for k, v in target.items():
            if k in raw:
                out[k] = _merge(v, raw[k], local, f"{path}/{k}")
            else:
                local.append(f"{path}/{k}")
                out[k] = v
        for k in raw.keys() - target.keys():
            out[k] = raw[k]
        if _REPLAY_SIG <= set(target) and any(
                loc.removeprefix(f"{path}/").split(" ")[0] in _REPLAY_DATA for loc in local):
            out["cursor"], out["size"] = target["cursor"], target["size"]
            local.append(f"{path}/cursor,size (reset with unrestored replay data)")
        skipped.extend(local)
        return out
    if torch.is_tensor(target):
        if torch.is_tensor(raw) and raw.shape == target.shape and raw.dtype == target.dtype:
            return raw
        got = tuple(raw.shape) if torch.is_tensor(raw) else type(raw).__name__
        skipped.append(f"{path} (shape {got} vs {tuple(target.shape)})")
        return target
    return raw


def _restore_into(target: Any, raw: Any, path: str) -> Any:
    skipped: list = []
    merged = _merge(_as_dict(target), raw, skipped)
    if skipped:
        print(f"checkpoint {path}: partial restore, kept fresh values for {len(skipped)} "
              f"leaves (first: {skipped[:3]})", file=sys.stderr)
    if isinstance(target, dict):
        return merged
    target.load_state_dict(merged)
    return target


def restore_latest(ckpt_dir: str, target: Any) -> tuple[Any, Optional[int]]:
    """Restore the newest ``ckpt_<step>.pt`` into ``target`` → (restored,
    step); (target, None) when there is none.  A dict target gives a new
    merged dict; a state with ``load_state_dict`` is restored in place and
    returned.

    A newer rank-0 file of a multi-process run wins over the global files:
    its replicated entries (networks, optimizers, counters) are whole, and
    its env and replay shards, sized for one rank, keep the target's fresh
    values through the lenient merge (one process's ``--eval-only`` or a
    fine-tune from a multi-process run)."""
    step = latest_step(ckpt_dir)
    ranks = sorted((int(m.group(1)), name) for name in _listdir(ckpt_dir)
                   if (m := _CKPT_RANK_RE.match(name)) and int(m.group(2)) == 0)
    if ranks and (step is None or ranks[-1][0] > step):
        step, name = ranks[-1]
    elif step is None:
        return target, None
    else:
        name = f"ckpt_{step}.pt"
    path = os.path.join(ckpt_dir, name)
    return _restore_into(target, _load(path), path), step


def _listdir(ckpt_dir: str) -> list:
    return os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []


def latest_sharded_step(ckpt_dir: str, world: int) -> Optional[int]:
    """The newest step whose ``world`` rank files all exist.  A set with a
    file missing (a rank died while saving) is skipped: resuming from it
    would restart that rank's shard fresh while the others go on."""
    ranks_by_step: dict[int, set] = {}
    for name in _listdir(ckpt_dir):
        if (m := _CKPT_RANK_RE.match(name)) and int(m.group(3)) == world:
            ranks_by_step.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
    complete = [s for s, r in ranks_by_step.items() if r >= set(range(world))]
    return max(complete) if complete else None


def _slice_global_to_local(local: Any, raw: Any, rank: int, world: int) -> Any:
    """A global checkpoint's entries cut to one rank's template: a tensor
    whose leading dim is exactly ``world`` times the template's (the rest
    of its shape equal) is a sharded field, and this rank keeps its
    contiguous block of rows (rank-major); entries that match already
    (replicated ones, host values) and anything else pass through for the
    lenient merge to judge."""
    if isinstance(local, dict):
        if not isinstance(raw, dict):
            return raw
        return {k: _slice_global_to_local(local[k], v, rank, world) if k in local else v
                for k, v in raw.items()}
    if (torch.is_tensor(local) and torch.is_tensor(raw) and local.ndim >= 1
            and raw.ndim == local.ndim and raw.shape[1:] == local.shape[1:]
            and local.shape[0] > 0 and raw.shape[0] == local.shape[0] * world):
        rows = local.shape[0]
        return raw[rank * rows:(rank + 1) * rows]
    return raw


def restore_latest_sharded(ckpt_dir: str, target: Any, mesh) -> tuple[Any, Optional[int]]:
    """A data-parallel resume: restore this rank's part of the newest
    checkpoint into ``target`` (this rank's state) → (restored, step).

    The newest of a complete set of ``world`` rank files (each rank reads
    its own) and a global ``ckpt_<step>.pt`` wins; a global file is cut to
    this rank (:func:`_slice_global_to_local`), and rank r takes the r-th
    of its ``rank_generators`` where it holds one per rank (rank 0 else its
    ``generator``, the other ranks keep their fresh generators).  The same
    lenient merge as :func:`restore_latest` follows.  Every rank must call
    this: the steps the ranks chose are compared in one all-gather before
    anything loads, and ranks that disagree (checkpoint directories out of
    sync between hosts) stop the run."""
    import torch.distributed as dist

    from cartpoleplusplus_tpu_torch.parallel.mesh import comm_device

    rank, world = mesh.rank, mesh.world
    step = latest_sharded_step(ckpt_dir, world)
    global_step = latest_step(ckpt_dir)
    use_global = global_step is not None and (step is None or global_step > step)
    step = global_step if use_global else step
    mine = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                        device=comm_device(mesh))
    steps = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(steps, mine, group=mesh.group)
    steps = [int(s) for s in steps]
    if len(set(steps)) > 1:
        raise SystemExit(f"checkpoint resume aborted: ranks disagree on the newest restorable "
                         f"step ({steps}); sync the checkpoint directories and relaunch")
    if step is None:
        return target, None
    name = f"ckpt_{step}.pt" if use_global else f"ckpt_{step}.rank{rank}of{world}.pt"
    path = os.path.join(ckpt_dir, name)
    raw = _load(path)
    if use_global:
        local = _to_cpu(_as_dict(target))
        raw = _slice_global_to_local(local, raw, rank, world)
        gens = raw.pop("rank_generators", None)
        if gens is not None and len(gens) == world:
            raw["generator"] = gens[rank]
        elif rank > 0 and "generator" in local:
            raw["generator"] = local["generator"]
    return _restore_into(target, raw, path), step


def restore_best(ckpt_dir: str, target: Any) -> tuple[Any, Optional[int]]:
    """Restore ``ckpt_best.pt`` as :func:`restore_latest` restores → (restored,
    step of its meta); (target, None) when absent."""
    path = os.path.join(ckpt_dir, _BEST_NAME)
    if not os.path.exists(path):
        return target, None
    raw = _load(path)
    step = int(raw["_best_meta"]["step"])
    return _restore_into(target, raw["state"], path), step

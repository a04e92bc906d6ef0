"""Env-sharded data parallelism over ``torch.distributed``: port of
cartpoleplusplus_tpu.parallel.distributed.

The layout is the JAX package's:

* the env batch, the replay buffer, the observations and the exploration
  noise shard along their leading (env / replay-capacity) dim, one shard
  per rank, with no traffic between ranks on the sim and replay path;
* the networks and the optimizer states are replicated: each rank computes
  gradients on its own replay batch and they are averaged over the ranks
  (``allreduce_mean_``, JAX's ``pmean``) before the clip and the Adam step,
  so the replicas stay byte-equal;
* the per-rank program is the one-card segment, built with the group.

Where JAX decorrelates one replicated key per chip with ``fold_in``, each
port rank owns a generator: rank 0 keeps the one-card run's, so a 1-rank
group reproduces the plain segment byte for byte, and rank r > 0 seeds a
fresh one from ``(seed, r)`` (:func:`rank_seed`).  The host ints a state
carries (the step counters, the replay cursor and fill) advance alike on
every rank because every rank runs the same number of steps of the same
shape; they are never reduced.

:func:`launch` starts the ranks of one launcher (``--num-devices /
--num-processes`` of them, global rank ``process_id · N/P + local``): one
rank runs in the launcher's own process, more are started with
``torch.multiprocessing`` (``spawn``, which CUDA needs).  A rank that dies,
or that does not finish within its time limit (:func:`rank_timeout_s`),
makes the launcher exit nonzero, and the other ranks are killed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import sys
import threading
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cartpoleplusplus_tpu_torch import kernels, resolve_device
from cartpoleplusplus_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S, Mesh, comm_device, destroy, free_port, init_process_group, replicate,
    shard_leading)

SHARD, REPLICATE = "shard", "replicate"
_REPLAY_SIG = {"s1", "action", "reward", "s2", "terminal", "cursor", "size"}
_REPLAY_ROWS = ("s1", "action", "reward", "terminal")
# A rank's time limit in seconds, read by :func:`rank_timeout_s`.
RANK_TIMEOUT_ENV = "CARTPOLEPP_RANK_TIMEOUT_S"
# A multiplier that is odd, so r ↦ r·M mod 2**32 is a bijection: rank seeds
# differ from each other and from ``seed`` for every rank r > 0, and from
# the evals' ``seed + 1`` unless r ≡ 244002641 (M's inverse) mod 2**32.
_RANK_SEED_MULT = 0x9E3779B1

# This rank's seconds per distributed segment (or on-policy update).
RANK_STATS = {"segment_s": []}
# The reports of the ranks of the last :func:`launch` in this process.
LAST_REPORTS: list = []


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: ``(seed + rank·0x9E3779B1)
    mod 2**32`` (32 bits, so the CPU's Mersenne twister, which keeps only
    the low 32 bits of a seed, sees distinct seeds too)."""
    return (seed + rank * _RANK_SEED_MULT) % 2**32


def rank_timeout_s() -> float:
    """A rank's time limit: ``$CARTPOLEPP_RANK_TIMEOUT_S`` seconds, one
    day when unset."""
    return float(os.environ.get(RANK_TIMEOUT_ENV, DEFAULT_TIMEOUT_S))


def _map_tree(v, leaf):
    if isinstance(v, dict):
        return {k: _map_tree(x, leaf) for k, x in v.items()}
    return None if v is None else leaf(v)


def _replay_specs(rd: dict) -> dict:
    specs = {k: REPLICATE for k in rd}  # cursor, size and block
    specs.update(dict.fromkeys(_REPLAY_ROWS, SHARD))
    # s2 is a (0,) placeholder in the s2-free mode, priority (0,) in a
    # uniform replay: replicated then.  priority may be None on a
    # hand-built state; its spec is None too, so both trees keep one shape.
    specs["s2"] = SHARD if rd["s2"].numel() else REPLICATE
    p = rd.get("priority")
    specs["priority"] = None if p is None else SHARD if p.numel() else REPLICATE
    return specs


def state_specs(st, sharded_fields: tuple) -> dict:
    """The partition of a training state: its ``state_dict()`` (or a state
    dict) with each leaf replaced by ``SHARD`` (split along the leading dim)
    or ``REPLICATE``, None where the leaf is None.

    ``sharded_fields``: the names of the fields whose tensors shard; in a
    replay the cursor, the fill and the block stay replicated (every shard
    writes as many rows per step).  Everything else (networks, optimizer
    states, the generator's state, step counters) replicates.  Names, not
    shapes, decide, as in the JAX package: a hidden layer as wide as the env
    count would be split as a weight matrix under a rule of shapes.
    """
    sd = st if isinstance(st, dict) else st.state_dict()
    sharded = lambda x: SHARD if torch.is_tensor(x) and x.ndim >= 1 else REPLICATE
    out = {}
    for k, v in sd.items():
        if k not in sharded_fields:
            out[k] = _map_tree(v, lambda _: REPLICATE)
        elif isinstance(v, dict) and _REPLAY_SIG <= set(v):
            out[k] = _replay_specs(v)
        else:
            out[k] = _map_tree(v, sharded)
    return out


def _shard_field(v, mesh: Mesh):
    """A state field's object with this rank's rows of every tensor that
    :func:`state_specs` shards (a replay by its rules; dataclasses field by
    field)."""
    if torch.is_tensor(v):
        return shard_leading(mesh, v) if v.ndim >= 1 else v
    if not dataclasses.is_dataclass(v):
        return v
    if {"s1", "s2", "priority", "cursor"} <= {f.name for f in dataclasses.fields(v)}:
        specs = _replay_specs({f.name: getattr(v, f.name) for f in dataclasses.fields(v)})
        return dataclasses.replace(v, **{k: shard_leading(mesh, getattr(v, k))
                                         for k, s in specs.items() if s == SHARD})
    return dataclasses.replace(v, **{f.name: _shard_field(getattr(v, f.name), mesh)
                                     for f in dataclasses.fields(v)})


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def shard_state(st, mesh: Mesh, sharded_fields: tuple):
    """A global training state (env and replay sized for the whole job)
    becomes this rank's, in place → ``st``.

    Every sharded field keeps this rank's rows (:func:`state_specs`);
    every replicated tensor (networks, optimizer states, SAC's temperature)
    is broadcast from rank 0, so replicas cannot start apart; rank r > 0
    takes a generator of its own, seeded by :func:`rank_seed` from the
    seed rank 0's generator was made with."""
    for name in sharded_fields:
        setattr(st, name, _shard_field(getattr(st, name), mesh))
    sd = st.state_dict()
    replicate(mesh, [t for k, v in sd.items() if k not in sharded_fields and k != "generator"
                     for t in _tensors(v)])
    if mesh.rank > 0:
        g = st.generator
        st.generator = torch.Generator(device=g.device).manual_seed(
            rank_seed(g.initial_seed(), mesh.rank))
    return st


def allreduce_mean_(tensors: list, group) -> None:
    """Average ``tensors`` over the group's ranks in place: flattened into
    one float32 buffer, one ``all_reduce`` (SUM), then divided by the world
    size (gloo has no AVG).  Under gloo the buffer goes through host
    memory.  A 1-rank group leaves every value as it was."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    buf = torch.cat([t.detach().reshape(-1).to(comm_device(group), torch.float32)
                     for t in tensors])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    buf /= dist.get_world_size(group)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(buf[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def make_distributed(mesh: Mesh, per_rank_segment, sharded_fields: tuple,
                     metric_keys: tuple):
    """The distributed form of any per-rank segment → ``(segment,
    shard_state)``.

    ``per_rank_segment``: ``(st, …) -> metrics``, built with ``group=
    mesh.group`` so it averages its gradients.  ``segment`` runs it on this
    rank's state, then averages the metric scalars of ``metric_keys`` over
    the ranks in one all-reduce (JAX's ``pmean`` of the metrics) and records
    its seconds in ``RANK_STATS``.  ``shard_state(st)`` places a global state
    (:func:`shard_state`)."""

    def segment(st, *args, **kwargs):
        t = time.monotonic()
        metrics = per_rank_segment(st, *args, **kwargs)
        allreduce_mean_([metrics[k] for k in metric_keys if torch.is_tensor(metrics.get(k))],
                        mesh.group)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        RANK_STATS["segment_s"].append(time.monotonic() - t)
        return metrics

    return segment, lambda st: shard_state(st, mesh, sharded_fields)


def broadcast_floats(mesh: Mesh, values) -> list[float]:
    """Rank 0's ``values`` (floats or 0-d tensors) on every rank."""
    buf = torch.tensor([float(v) for v in values], dtype=torch.float64,
                       device=comm_device(mesh))
    dist.broadcast(buf, src=0, group=mesh.group)
    return buf.tolist()


def _gather_rows(t: torch.Tensor, mesh: Mesh) -> list | None:
    """Every rank's ``t`` (of one shape on all ranks) on rank 0, None
    elsewhere, moved as bytes."""
    dev = comm_device(mesh)
    b = t.detach().contiguous().reshape(-1).view(torch.uint8).to(dev)
    out = [torch.empty_like(b) for _ in range(mesh.world)] if mesh.rank == 0 else None
    dist.gather(b, out, dst=0, group=mesh.group)
    return None if out is None else [o.cpu().view(t.dtype).view(t.shape) for o in out]


def global_state_dict(st, mesh: Mesh, sharded_fields: tuple) -> dict | None:
    """The job's global state (a training state or its state dict) as one
    state dict, on rank 0 (None on the others; every rank must call this):
    each sharded tensor gathered
    rank-major along its leading dim (the JAX package's device-major
    global arrays), every replicated entry rank 0's, and beside rank 0's
    ``generator`` the list of every rank's generator state as
    ``rank_generators``, so a resume on as many ranks takes each its own."""
    sd = st if isinstance(st, dict) else st.state_dict()
    specs = state_specs(sd, sharded_fields)

    def gather(v, spec):
        if isinstance(v, dict):
            return {k: gather(x, spec[k]) for k, x in v.items()}
        if spec == SHARD:
            parts = _gather_rows(v, mesh)
            return None if parts is None else torch.cat(parts)
        return v

    out = gather(sd, specs)
    gens = _gather_rows(sd["generator"], mesh) if "generator" in sd else None
    if mesh.rank:
        return None
    if gens is not None:
        out["rank_generators"] = gens
    return out


# ---------------------------------------------------------------------------
# DDPG (the JAX package's flagship multi-chip path)
# ---------------------------------------------------------------------------

DDPG_SHARDED_FIELDS = ("replay", "env_states", "obs", "ou_noise")
DDPG_METRIC_KEYS = ("critic_loss", "actor_loss", "reward", "done_frac", "double_reset_frac")


def make_distributed_segment(mesh: Mesh, local_venv, **segment_kw):
    """DDPG's distributed segment → ``(segment, shard_state)``.

    ``local_venv`` is sized for one rank's env shard (global envs / world);
    ``segment_kw`` are ``ddpg.make_segment``'s, ``batch_size`` the
    per-rank replay batch (global batch = batch × world)."""
    from cartpoleplusplus_tpu_torch.agents import ddpg

    per_rank = ddpg.make_segment(local_venv, group=mesh.group, **segment_kw)
    return make_distributed(mesh, per_rank, DDPG_SHARDED_FIELDS, DDPG_METRIC_KEYS)


def global_ddpg_state(config, global_envs: int, replay_capacity: int, seed: int = 0,
                      num_devices: int = 1, device=None, **init_kw):
    """A DDPG state with env and replay sized for the whole job, as
    ``ddpg.init_state`` builds it on one card at ``global_envs`` (the
    replay's insertion block sized per shard,
    ``agents.common.replay_block``); place it with :func:`shard_state`."""
    from cartpoleplusplus_tpu_torch.agents import common, ddpg

    opts = SimpleNamespace(seed=seed, replay_capacity=replay_capacity, num_devices=num_devices)
    venv = common.make_venv(config, global_envs, device=device)
    return ddpg.init_state(opts, config, venv, **init_kw)


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------


class RankFailure(RuntimeError):
    """A rank exited nonzero, without a result, or past its time limit."""


def _cpu_threads(device, ranks: int) -> int | None:
    """Intra-op threads of each of ``ranks`` CPU ranks on one host: this
    process's share, so the ranks do not oversubscribe its cores."""
    if resolve_device(device).type != "cpu":
        return None
    return max(1, torch.get_num_threads() // ranks)


def _rank_entry(local_rank: int, rank: int, world: int, coordinator: str, device,
                timeout_s: float, threads: int | None, work: bytes, queue) -> object:
    """One rank: join the group, run ``fn(mesh, *args)`` (``work`` is their
    pickle), leave (in order, :func:`mesh.destroy`, unless ``fn`` raised);
    the result goes to ``queue``, pickled, when there is one.  Plain
    pickles copy tensors: torch's shared-memory handles would outlive the
    process that made them."""
    if threads is not None:
        torch.set_num_threads(threads)
    fn, args = pickle.loads(work)
    try:
        out = fn(init_process_group(coordinator, rank, world, local_rank, device, timeout_s),
                 *args)
    except BaseException:
        destroy(orderly=False)
        raise
    destroy()
    if queue is not None:
        queue.put((local_rank, pickle.dumps(out, pickle.HIGHEST_PROTOCOL)))
    return out


def _spawn(ranks: list[int], world: int, coordinator: str, device, timeout_s: float, fn,
           args: tuple) -> list:
    """Start ``ranks`` (this host's global ranks) as spawned processes,
    each running :func:`_rank_entry`, and wait for all of them → their
    results by local rank.  A rank that exits nonzero or without a result,
    or a wait past ``timeout_s``, kills the rest and raises
    :class:`RankFailure`."""
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    threads = _cpu_threads(device, len(ranks))
    work = pickle.dumps((fn, args), pickle.HIGHEST_PROTOCOL)
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(local, rank, world, coordinator, device, timeout_s, threads, work,
                               queue))
             for local, rank in enumerate(ranks)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            while not queue.empty():
                local, out = queue.get()
                results[local] = pickle.loads(out)
            codes = [p.exitcode for p in procs]
            failed = [(ranks[i], c) for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RankFailure(f"rank {failed[0][0]} of {world} exited with code "
                                  f"{failed[0][1]}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                late = [ranks[i] for i, c in enumerate(codes) if c is None]
                raise RankFailure(f"ranks {late} of {world} did not finish within "
                                  f"{timeout_s:g} s")
            procs[codes.index(None)].join(0.05)
        while not queue.empty():
            local, out = queue.get()
            results[local] = pickle.loads(out)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    missing = [ranks[i] for i in range(len(procs)) if i not in results]
    if missing:
        raise RankFailure(f"ranks {missing} of {world} exited without a result")
    return [results[i] for i in range(len(procs))]


def run_ranks(world: int, fn, *args, device="cpu", timeout_s: float | None = None) -> list:
    """``fn(mesh, *args)`` on ``world`` spawned ranks of one group on this
    host → each rank's result, by rank.  ``fn`` must be a module-level
    function (``spawn`` pickles it by name)."""
    timeout_s = rank_timeout_s() if timeout_s is None else timeout_s
    return _spawn(list(range(world)), world, f"localhost:{free_port()}", device, timeout_s,
                  fn, args)


def _say(line: dict) -> None:
    """One ``PARALLEL {json}`` line on stderr, in one write, so the lines of
    ranks that share a pipe do not interleave."""
    sys.stderr.write("PARALLEL " + json.dumps(line) + "\n")
    sys.stderr.flush()


def _train_rank(mesh: Mesh, opts, train, args: tuple) -> dict:
    """A rank of :func:`launch`: ``train(opts, *args)`` with a line on
    stderr at its start (rank, world, backend, device) and at its end (the
    result, the kernel launches and seconds per segment of this rank) →
    the end line's report."""
    RANK_STATS["segment_s"].clear()
    before = dict(kernels.LAUNCHES)
    head = {"rank": mesh.rank, "world": mesh.world, "process_id": opts.process_id,
            "local_rank": mesh.local_rank, "backend": mesh.backend, "device": str(mesh.device)}
    _say({"event": "start", **head})
    result = train(opts, *args)
    report = {"event": "end", **head, "result": result,
              "launches": {k: v - before[k] for k, v in kernels.LAUNCHES.items()},
              "segment_s": list(RANK_STATS["segment_s"])}
    _say(report)
    return report


def _expire(rank: int, timeout_s: float) -> None:
    print(f"rank {rank} did not finish within {timeout_s:g} s", file=sys.stderr, flush=True)
    os._exit(124)


def launch(opts, train, *args) -> float:
    """Run ``train(opts, *args)`` on this launcher's ranks → the result of
    its first rank (rank 0's final eval on launcher 0; every rank's eval is
    rank 0's, broadcast).

    ``--num-devices`` N ranks in all, ``--num-processes`` P launchers, this
    one ``--process-id`` k: ranks ``k·N/P .. (k+1)·N/P − 1``, local ranks
    from 0.  The group meets at ``--coordinator`` when P > 1, else at a
    free localhost port.  With CUDA the kernels are built here first, so
    the ranks load them and never race to compile.  A launcher of one rank
    runs it in its own process, under a timer that ends the process (exit
    124) at the time limit; more are spawned.  The ranks' reports
    (:func:`_train_rank`) are kept in ``LAST_REPORTS``."""
    n, p = opts.num_devices, max(opts.num_processes, 1)
    local = n // p
    first = opts.process_id * local
    coordinator = opts.coordinator if p > 1 else f"localhost:{free_port()}"
    timeout_s = rank_timeout_s()
    if resolve_device(opts.device).type == "cuda":
        kernels.build()
    if local == 1:
        timer = threading.Timer(timeout_s, _expire, args=(first, timeout_s))
        timer.daemon = True
        timer.start()
        try:
            reports = [_rank_entry(0, first, n, coordinator, opts.device, timeout_s, None,
                                   pickle.dumps((_train_rank, (opts, train, args))), None)]
        finally:
            timer.cancel()
    else:
        try:
            reports = _spawn(list(range(first, first + local)), n, coordinator, opts.device,
                             timeout_s, _train_rank, (opts, train, args))
        except RankFailure as e:
            raise SystemExit(f"parallel launch failed: {e}") from e
    LAST_REPORTS[:] = reports
    return reports[0]["result"]

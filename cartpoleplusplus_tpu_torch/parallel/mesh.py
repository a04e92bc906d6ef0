"""Process groups for env-sharded data parallelism: port of
cartpoleplusplus_tpu.parallel.mesh.

The JAX package puts every chip of a job on one 1-D mesh (axis ``"env"``)
and runs one program over it under ``shard_map``.  The port follows
PyTorch's idiom instead: one process per rank and one device per rank, the
ranks joined in a ``torch.distributed`` process group.  A :class:`Mesh` is
this process's view of that group: its rank, the world size, its local rank
on the host and its device.  Local rank ``l`` runs on ``cuda:(l %
device_count)``, or on the CPU when the run asked for ``--device cpu``.

The backend is fixed by one rule before anything runs
(:func:`choose_backend`): gloo on the CPU, NCCL where every rank has a card
of its own, gloo where ranks share a card (NCCL refuses two ranks on one
device; gloo stages CUDA tensors through host memory).  A backend that
fails to initialise or to reduce is an error; nothing retries on the
other one.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import socket
from typing import Optional

import torch
import torch.distributed as dist

from cartpoleplusplus_tpu_torch import resolve_device

# A rank's default time limit (seconds) for the store, the collectives and
# the launcher's join.
DEFAULT_TIMEOUT_S = 24 * 3600.0
# The store key each rank > 0 sets once it has left the group.
_LEFT_KEY = "cartpole_left/{}"

_CURRENT: Optional["Mesh"] = None
# This rank's client of the job's TCP store (rank 0's also serves it).
_STORE = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's rank in the job's process group."""

    group: object          # the torch.distributed process group
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str           # "nccl" or "gloo"


def free_port() -> int:
    """A TCP port that is free on localhost now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(local_rank: int, device=None) -> torch.device:
    """Local rank ``local_rank``'s device: ``cuda:(local_rank %
    device_count)``, or the CPU when ``device`` asks for it."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _device_id(device: torch.device) -> str:
    """What names ``device`` across the job: the host and the card's UUID."""
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def choose_backend(store, rank: int, world: int, device: torch.device) -> str:
    """The backend of the rule in this module's docstring.  Every rank
    publishes its device on ``store`` and reads everyone's, so all ranks
    choose alike before the group exists."""
    if device.type == "cpu":
        return "gloo"
    store.set(f"cartpole_device/{rank}", _device_id(device))
    ids = {store.get(f"cartpole_device/{r}").decode() for r in range(world)}
    return "nccl" if len(ids) == world else "gloo"


def init_process_group(coordinator: str, rank: int, world: int, local_rank: int = 0,
                       device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the job's process group over a TCP store at ``coordinator``
    (``host:port``; rank 0 serves it) and make the result this process's
    :func:`current_mesh`.  CUDA ranks set their device first."""
    global _CURRENT, _STORE
    if _CURRENT is not None:
        raise RuntimeError("this process already holds a rank")
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    dev = rank_device(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)
    backend = choose_backend(store, rank, world, dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timeout)
    _CURRENT = Mesh(group=dist.group.WORLD, rank=rank, world=world, local_rank=local_rank,
                    device=dev, backend=backend)
    _STORE = store
    return _CURRENT


def current_mesh() -> Optional[Mesh]:
    """The mesh this process is a rank of, or None outside a rank."""
    return _CURRENT


def destroy(orderly: bool = True) -> None:
    """Leave the process group (a no-op outside a rank).

    ``orderly`` (every rank of the job calls it once its work is done): a
    barrier first, so no rank tears its group down while a peer's
    collective is in flight; then the group is destroyed and freed (where
    the caller keeps no reference to it), so its gloo threads end while
    every peer's process is still up, not in this process's interpreter
    teardown; then each rank > 0 checks out on the store while rank 0,
    whose process serves the store, waits for all of them before its store
    goes.  ``orderly=False`` (a rank whose work raised), or a barrier that
    fails because a peer has gone already: the group is destroyed at once,
    without waiting for peers that may never arrive; the peer's own
    failure is the one to report."""
    global _CURRENT, _STORE
    if _CURRENT is None:
        return
    rank, world, group, store = _CURRENT.rank, _CURRENT.world, _CURRENT.group, _STORE
    orderly = orderly and world > 1
    try:
        if orderly:
            dist.barrier(group=group)
    except RuntimeError:
        orderly = False
    finally:
        dist.destroy_process_group()
        _CURRENT = _STORE = group = None
        gc.collect()
    if orderly:
        if rank == 0:
            store.wait([_LEFT_KEY.format(r) for r in range(1, world)])
        else:
            store.set(_LEFT_KEY.format(rank), "1")


def comm_device(mesh_or_group) -> torch.device:
    """Where a collective's tensors live: the rank's card under NCCL, the
    host under gloo."""
    backend = (mesh_or_group.backend if isinstance(mesh_or_group, Mesh)
               else dist.get_backend(mesh_or_group))
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_leading(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global tensor: the ``rank``-th of ``world``
    equal blocks along the leading dim (device-major, as the JAX mesh
    places them), as a contiguous copy."""
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"leading dim {n} does not split over {mesh.world} ranks")
    rows = n // mesh.world
    return x[mesh.rank * rows:(mesh.rank + 1) * rows].clone()


def replicate(mesh: Mesh, tensors: list) -> list:
    """Make every rank's ``tensors`` rank 0's, in place, with one broadcast
    of their bytes."""
    tensors = [t for t in tensors if torch.is_tensor(t) and t.numel()]
    if not tensors or mesh.world == 1:
        return tensors
    dev = comm_device(mesh)
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat([f.to(dev) for f in flat])
    dist.broadcast(buf, src=0, group=mesh.group)
    offset = 0
    for t, f in zip(tensors, flat):
        chunk = buf[offset:offset + f.numel()].clone().view(t.dtype).view(t.shape)
        with torch.no_grad():
            t.copy_(chunk.to(t.device))
        offset += f.numel()
    return tensors

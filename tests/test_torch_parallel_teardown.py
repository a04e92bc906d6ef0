"""The teardown of the port's gloo ranks (``parallel/mesh.py`` ``destroy``,
``parallel/distributed.py`` ``_rank_entry``) on the CPU: several short
rounds of ``run_ranks(2, …)`` in one process, each rank doing a few
collectives and then leaving while its peer is still busy, and every rank of
every round exiting 0 with its result.

The ranks run module-level functions of this file (a spawned rank imports
it by name); nothing here imports JAX.
"""

import time

import pytest
import torch
import torch.distributed as dist

from cartpoleplusplus_tpu_torch import parallel
from cartpoleplusplus_tpu_torch.parallel.mesh import free_port

ROUNDS = 3


def _reduce_then_leave(mesh, late_rank: int) -> float:
    """A few all-reduces, then rank ``late_rank`` works on for a while, so
    its peer reaches the teardown first."""
    t = torch.full((1024,), float(mesh.rank + 1))
    for _ in range(4):
        dist.all_reduce(t, group=mesh.group)
    if mesh.rank == late_rank:
        time.sleep(0.2)
    return float(t[0])


@pytest.mark.parametrize("late_rank", [0, 1], ids=["store_host_late", "store_host_early"])
def test_rounds_of_two_ranks_all_exit_zero(late_rank):
    for _ in range(ROUNDS):
        # run_ranks raises RankFailure unless every rank exits 0 with a result.
        out = parallel.run_ranks(2, _reduce_then_leave, late_rank, timeout_s=120)
        assert out == [3.0 * 2 ** 3] * 2


def test_one_process_joins_and_leaves_again():
    """``destroy`` leaves this process outside any rank, so it can join a
    new group, round after round."""
    for _ in range(3):
        mesh = parallel.init_process_group(f"localhost:{free_port()}", 0, 1, device="cpu")
        try:
            t = torch.ones(3)
            dist.all_reduce(t, group=mesh.group)
            assert t.tolist() == [1.0] * 3
        finally:
            parallel.destroy()
        assert parallel.current_mesh() is None and not dist.is_initialized()

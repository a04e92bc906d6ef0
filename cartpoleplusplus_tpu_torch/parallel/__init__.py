"""Parallelism layer: port of cartpoleplusplus_tpu.parallel — env-sharded
data parallelism over ``torch.distributed``, one process and one device per
rank, the gradients averaged over the ranks."""

from cartpoleplusplus_tpu_torch.parallel.distributed import (
    DDPG_METRIC_KEYS,
    DDPG_SHARDED_FIELDS,
    allreduce_mean_,
    global_ddpg_state,
    global_state_dict,
    launch,
    make_distributed,
    make_distributed_segment,
    rank_seed,
    run_ranks,
    shard_state,
    state_specs,
)
from cartpoleplusplus_tpu_torch.parallel.mesh import (
    Mesh,
    current_mesh,
    destroy,
    init_process_group,
    replicate,
    shard_leading,
)

__all__ = [
    "DDPG_METRIC_KEYS",
    "DDPG_SHARDED_FIELDS",
    "allreduce_mean_",
    "global_ddpg_state",
    "global_state_dict",
    "launch",
    "make_distributed",
    "make_distributed_segment",
    "rank_seed",
    "run_ranks",
    "shard_state",
    "state_specs",
    "Mesh",
    "current_mesh",
    "destroy",
    "init_process_group",
    "replicate",
    "shard_leading",
]

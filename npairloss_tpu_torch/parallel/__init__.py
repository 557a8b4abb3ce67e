"""Distribution: the process-group runtime, the mesh and its collectives,
engine planning and the ring engine — port of ``npairloss_tpu/parallel``.

One process per device over ``torch.distributed`` (NCCL on cards, gloo
on the CPU); the mesh is a 1-D process group in ring order.  Not ported:
``partition.py`` (the dp x mp parameter sharding) and ``shard_map``,
which a process-per-device design does not need."""

from npairloss_tpu_torch.parallel.distributed import (
    initialize_distributed,
    process_local_batch,
    process_topology,
    shutdown_distributed,
)
from npairloss_tpu_torch.parallel.mesh import (
    DEFAULT_AXIS,
    Mesh,
    build_mesh,
    data_parallel_mesh,
    mesh_topology,
    shard_batch,
    sharded_npair_loss_fn,
)
from npairloss_tpu_torch.parallel.plan import (
    EnginePlan,
    host_counts,
    plan_engine,
    plan_for_mesh,
    ring_device_order,
)
from npairloss_tpu_torch.parallel.ring import (
    ring_npair_loss_and_metrics,
    ring_supported,
)

__all__ = [
    "DEFAULT_AXIS",
    "EnginePlan",
    "Mesh",
    "build_mesh",
    "data_parallel_mesh",
    "host_counts",
    "initialize_distributed",
    "mesh_topology",
    "plan_engine",
    "plan_for_mesh",
    "process_local_batch",
    "process_topology",
    "ring_device_order",
    "ring_npair_loss_and_metrics",
    "ring_supported",
    "shard_batch",
    "sharded_npair_loss_fn",
    "shutdown_distributed",
]

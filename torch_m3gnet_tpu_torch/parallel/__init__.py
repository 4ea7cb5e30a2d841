"""Data and graph parallelism on ``torch.distributed``, one process per
rank (counterpart of ``torch_m3gnet_tpu.parallel``; the same names)."""

from torch_m3gnet_tpu_torch.parallel.dp import DataParallel, shard_stack, unshard
from torch_m3gnet_tpu_torch.parallel.graph_shard import (
    GraphParallelPotential,
    GraphParallelTrainer,
    halo_stats,
    partition_graph,
    stack_partitions,
)
from torch_m3gnet_tpu_torch.parallel.mesh import make_mesh

__all__ = [
    "make_mesh",
    "DataParallel",
    "shard_stack",
    "unshard",
    "GraphParallelPotential",
    "GraphParallelTrainer",
    "halo_stats",
    "partition_graph",
    "stack_partitions",
]

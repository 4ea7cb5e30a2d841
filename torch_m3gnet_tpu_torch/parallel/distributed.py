"""Starting the process group, and each rank's part of a global batch.

Counterpart of ``torch_m3gnet_tpu.parallel.distributed``. JAX starts one
process per host and addresses every chip of the job from it; the port
runs one process per rank, each on its own card, and every rank calls
:func:`initialize`. Data loading stays local: each rank builds and feeds
only its own row of a global batch (:func:`host_local_to_global`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from torch_m3gnet_tpu_torch.data.graph import GraphBatch
from torch_m3gnet_tpu_torch.parallel.mesh import make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    platform: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` from the arguments, else
    from the JAX package's variables ``COORDINATOR_ADDRESS`` (``host:port``
    of rank 0), ``NUM_PROCESSES`` and ``PROCESS_ID``, else from torchrun's
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    ``backend`` defaults to NCCL for ``platform`` ``"cuda"`` (the default)
    and gloo for ``"cpu"``; the caller picks any other. A failing backend
    raises: there is no fallback to another one.
    """
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    world = num_processes or env.get("NUM_PROCESSES") or env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("PROCESS_ID", env.get("RANK"))
    if world is None or rank is None:
        raise RuntimeError("initialize needs the world size and this process's rank: pass "
                           "them, set NUM_PROCESSES and PROCESS_ID, or run under torchrun")
    backend = backend or ("gloo" if platform == "cpu" else "nccl")
    dist.init_process_group(backend, init_method=f"tcp://{addr}" if addr else "env://",
                            world_size=int(world), rank=int(rank))


def global_mesh(axis_name: str = "dp", platform: Optional[str] = None, device=None):
    """A 1-D mesh over every rank of the job."""
    return make_mesh(None, axis_name, platform, device)


def host_local_to_global(mesh, batch: GraphBatch, axis_name: str = "dp") -> GraphBatch:
    """This rank's shard of a batch stacked along a leading device axis.

    JAX assembles a global array from each host's stacked shards; here a
    rank holds one shard, so it passes either its own stack of one (leading
    axis 1) or the whole stack (one row per rank of ``axis_name``) and
    keeps its row."""
    rows, size = len(batch.positions), mesh.size(mesh.mesh_dim_names.index(axis_name))
    if rows == 1:
        return batch.row(0)
    if rows != size:
        raise ValueError(f"a stack of {rows} shards on a {axis_name!r} axis of {size} ranks")
    return batch.row(mesh.get_local_rank(axis_name))

from torch_m3gnet_tpu_torch.data.dataset import BucketSpec, batch_iterator, split_dataset
from torch_m3gnet_tpu_torch.data.graph import (
    GraphBatch,
    batch_graphs,
    cast_batch,
    graph_from_structure,
    pack_structures,
    pad_batch,
    round_up,
    to_torch,
    triplet_counts,
)
from torch_m3gnet_tpu_torch.data.neighborlist import neighbor_list_pbc
from torch_m3gnet_tpu_torch.data.structure import Structure
from torch_m3gnet_tpu_torch.data.triplets import compute_threebody

__all__ = [
    "BucketSpec",
    "GraphBatch",
    "Structure",
    "batch_graphs",
    "batch_iterator",
    "cast_batch",
    "compute_threebody",
    "graph_from_structure",
    "neighbor_list_pbc",
    "pack_structures",
    "pad_batch",
    "round_up",
    "split_dataset",
    "to_torch",
    "triplet_counts",
]

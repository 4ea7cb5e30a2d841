from torch_m3gnet_tpu_torch.data.graph import (
    GraphBatch,
    batch_graphs,
    graph_from_structure,
    pack_structures,
    pad_batch,
    round_up,
    to_torch,
)
from torch_m3gnet_tpu_torch.data.neighborlist import neighbor_list_pbc
from torch_m3gnet_tpu_torch.data.structure import Structure
from torch_m3gnet_tpu_torch.data.triplets import compute_threebody

__all__ = [
    "GraphBatch",
    "Structure",
    "batch_graphs",
    "compute_threebody",
    "graph_from_structure",
    "neighbor_list_pbc",
    "pack_structures",
    "pad_batch",
    "round_up",
    "to_torch",
]

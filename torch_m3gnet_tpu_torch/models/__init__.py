from torch_m3gnet_tpu_torch.models.convert import params_from_flax
from torch_m3gnet_tpu_torch.models.m3gnet import (
    M3GNet,
    M3GNetPotential,
    PotentialOutput,
    build_model,
    edge_vectors_fm,
)

__all__ = [
    "M3GNet",
    "M3GNetPotential",
    "PotentialOutput",
    "build_model",
    "edge_vectors_fm",
    "params_from_flax",
]

from torch_m3gnet_tpu_torch.models.convert import flax_from_params, params_from_flax
from torch_m3gnet_tpu_torch.models.chgnet import CHGNet
from torch_m3gnet_tpu_torch.models.ensemble import EnsemblePotential, stack_params
from torch_m3gnet_tpu_torch.models.m3gnet import (
    M3GNet,
    M3GNetPotential,
    Potential,
    PotentialOutput,
    build_model,
    edge_vectors_fm,
)

__all__ = [
    "CHGNet",
    "EnsemblePotential",
    "M3GNet",
    "M3GNetPotential",
    "Potential",
    "PotentialOutput",
    "build_model",
    "edge_vectors_fm",
    "flax_from_params",
    "params_from_flax",
    "stack_params",
]

"""PyTorch + CUDA port of ``torch_m3gnet_tpu`` (M3GNet interatomic potentials).

The JAX package stays the reference; this package imports nothing of it.
Entry point: ``models.build_model(config)`` -> potential; ``potential(batch)``
-> energy, forces, stress and atomic energies; ``train.Trainer`` trains it on
E/F/S targets. The three-body stage and the sorted segment sums run on
hand-written Hopper kernels (``csrc/``), built with ``nvcc`` at first use.
"""

from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.models import M3GNetPotential, build_model

__all__ = ["M3GNetConfig", "M3GNetPotential", "build_model"]

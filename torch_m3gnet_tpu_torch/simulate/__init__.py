"""Simulation with the port's potential: relaxation (FIRE, L-BFGS), MD
(NVE, NVT, NPT), trajectory observables, the equation of state, elastic
constants and phonons. Names as in ``torch_m3gnet_tpu.simulate``."""

from torch_m3gnet_tpu_torch.simulate.elastic import (
    bulk_modulus_voigt,
    elastic_tensor,
    force_constants,
    gamma_phonons,
    phonon_dispersion,
)
from torch_m3gnet_tpu_torch.simulate.eos import (
    birch_murnaghan,
    birch_murnaghan_fit,
    energy_volume_curve,
)
from torch_m3gnet_tpu_torch.simulate.md import MDConfig, MDResult, run_md
from torch_m3gnet_tpu_torch.simulate.observables import (
    diffusion_coefficient,
    mean_squared_displacement,
    phonon_dos_from_vacf,
    radial_distribution,
    velocity_autocorrelation,
    write_extxyz,
)
from torch_m3gnet_tpu_torch.simulate.relax import FireConfig, LbfgsConfig, relax_structures

__all__ = [
    "FireConfig",
    "LbfgsConfig",
    "relax_structures",
    "MDConfig",
    "MDResult",
    "run_md",
    "radial_distribution",
    "mean_squared_displacement",
    "diffusion_coefficient",
    "write_extxyz",
    "velocity_autocorrelation",
    "phonon_dos_from_vacf",
    "elastic_tensor",
    "bulk_modulus_voigt",
    "force_constants",
    "gamma_phonons",
    "phonon_dispersion",
    "energy_volume_curve",
    "birch_murnaghan",
    "birch_murnaghan_fit",
]

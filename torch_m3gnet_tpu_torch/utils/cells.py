"""Cell-manipulation helpers for tests and physics checks (own copy of
``torch_m3gnet_tpu.utils.cells`` on the port's ``Structure``)."""

from __future__ import annotations

import numpy as np

from torch_m3gnet_tpu_torch.data.structure import Structure


def rotate_cell(structure: Structure, rotation: np.ndarray) -> Structure:
    """Rigidly rotate lattice and coordinates: row vectors map v -> v R^T."""
    R = np.asarray(rotation, dtype=np.float64)
    return Structure(
        lattice=structure.lattice @ R.T,
        cart_coords=structure.cart_coords @ R.T,
        atomic_numbers=structure.atomic_numbers.copy(),
        properties=dict(structure.properties),
    )


def strain_cell(structure: Structure, strain: np.ndarray) -> Structure:
    """Apply A -> A (1 + eps) to lattice and cartesian coordinates."""
    eps = np.asarray(strain, dtype=np.float64).reshape(3, 3)
    F = np.eye(3) + eps
    return Structure(
        lattice=structure.lattice @ F.T,
        cart_coords=structure.cart_coords @ F.T,
        atomic_numbers=structure.atomic_numbers.copy(),
        properties=dict(structure.properties),
    )

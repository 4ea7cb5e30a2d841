"""Per-species reference-energy fit (own copy of
``torch_m3gnet_tpu.train.elemental``): least squares of total energies on
species counts, no intercept; the residual's standard deviation becomes the
energy scale."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from torch_m3gnet_tpu_torch.data.graph import GraphBatch


def fit_elemental_energies(
    graphs: Sequence[GraphBatch], num_types: int
) -> tuple[np.ndarray, float]:
    """Fit per-species energies from per-graph totals.

    Args:
        graphs: unpadded single host graphs with ``energy`` targets set.
        num_types: number of species columns (0-indexed atomic numbers).

    Returns:
        (elemental_energies (num_types,), energy_scale): the scale is the
        standard deviation of the residual total energies (>= 1e-8).
    """
    counts = np.zeros((len(graphs), num_types))
    energies = np.zeros(len(graphs))
    for i, g in enumerate(graphs):
        if g.energy is None:
            raise ValueError("all graphs need energy targets for the elemental fit")
        types = np.asarray(g.atom_types)[np.asarray(g.node_mask, dtype=bool)]
        counts[i] = np.bincount(types, minlength=num_types)
        energies[i] = float(np.asarray(g.energy).sum())
    coeffs, *_ = np.linalg.lstsq(counts, energies, rcond=None)
    residual = energies - counts @ coeffs
    scale = float(np.std(residual))
    return coeffs.astype(np.float64), max(scale, 1e-8)

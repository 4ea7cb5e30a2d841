"""Equation-of-state utilities: energy-volume curves + Birch-Murnaghan fit.

Counterpart of ``torch_m3gnet_tpu.simulate.eos``: the E(V) curve of one
cell under isotropic strain (the batch moves to the potential's device once;
each point replaces only positions and lattice, which keeps its kernel
index), and the third-order Birch-Murnaghan fit (scipy), which yields
(E0, V0, B0, B0').
"""

from __future__ import annotations

import numpy as np
import torch

from torch_m3gnet_tpu_torch.simulate.elastic import EV_PER_A3_TO_GPA
from torch_m3gnet_tpu_torch.simulate.relax import device_batch


def energy_volume_curve(potential, batch, strains=None) -> tuple[np.ndarray, np.ndarray]:
    """Volumes (A^3) and energies (eV) of a single-graph batch under
    isotropic strains (default 13 points in [-4 %, +4 %])."""
    if batch.num_graphs_real != 1:
        raise ValueError("energy_volume_curve expects a single-graph batch")
    if strains is None:
        strains = np.linspace(-0.04, 0.04, 13)
    strains = np.asarray(strains, dtype=np.float64)
    graph = device_batch(potential, batch)
    pos0 = torch.as_tensor(batch.positions).detach().to(graph.positions.device, torch.float64)
    lat0 = torch.as_tensor(batch.lattice).detach().to(graph.positions.device, torch.float64)
    v0 = abs(np.linalg.det(lat0[0].cpu().numpy()))
    dtype = graph.positions.dtype
    with torch.no_grad():
        energies = torch.stack([
            potential(graph.replace(positions=(pos0 * (1.0 + s)).to(dtype),
                                    lattice=(lat0 * (1.0 + s)).to(dtype))).energy[0].detach()
            for s in strains
        ])
    return v0 * (1.0 + strains) ** 3, energies.cpu().double().numpy()


def birch_murnaghan(v, e0, v0, b0, b0p):
    """Third-order Birch-Murnaghan E(V); b0 in eV/A^3."""
    eta = (v0 / v) ** (2.0 / 3.0)
    return e0 + 9.0 * v0 * b0 / 16.0 * (
        (eta - 1.0) ** 3 * b0p + (eta - 1.0) ** 2 * (6.0 - 4.0 * eta)
    )


def birch_murnaghan_fit(volumes, energies) -> dict:
    """Fit (E0, V0, B0, B0') to an E(V) curve; B0 returned in GPa too.

    Initial guesses come from a parabola in V; the fit needs the sampled
    range to bracket the minimum (raises otherwise).
    """
    from scipy.optimize import curve_fit

    v = np.asarray(volumes, dtype=np.float64)
    e = np.asarray(energies, dtype=np.float64)
    i = int(np.argmin(e))
    if i in (0, len(e) - 1):
        raise ValueError(
            "energy minimum is at the edge of the sampled volume range; "
            "widen the strain window"
        )
    coef = np.polyfit(v, e, 2)
    v0 = -coef[1] / (2 * coef[0])
    b0 = max(2 * coef[0] * v0, 1e-6)
    p, _ = curve_fit(birch_murnaghan, v, e, p0=[e.min(), v0, b0, 4.0], maxfev=20000)
    e0, v0, b0, b0p = map(float, p)
    resid = float(np.sqrt(np.mean((birch_murnaghan(v, *p) - e) ** 2)))
    return {
        "e0_ev": e0,
        "v0_a3": v0,
        "b0_ev_a3": b0,
        "b0_gpa": b0 * EV_PER_A3_TO_GPA,
        "b0_prime": b0p,
        "rms_resid_ev": resid,
    }

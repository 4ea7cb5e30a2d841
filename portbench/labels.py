"""Training labels from a seeded Morse pair potential, computed by the
benchmark itself (plain torch, float64), so that the inputs of the train
cells do not depend on the code under test.

E = 1/2 sum_{i != j} D [(1 - exp(-alpha (r - r0)))^2 - 1] fc(r) over every
pair within the two-body cutoff, r0 the sum of the pair's covalent radii,
fc the polynomial cutoff. D and alpha are drawn from the seed once per run.
Forces and stress by autograd, as the reference takes them; one graph a
batch.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import neighbors
from portbench.reference.model import cutoff_fn

# Covalent radii (Angstrom; Cordero et al., Dalton Trans. 2008) of the mp-mix species.
RADII = {3: 1.28, 6: 0.76, 8: 0.66, 9: 0.57, 11: 1.66, 12: 1.41, 13: 1.21, 14: 1.11,
         17: 1.02, 22: 1.60, 26: 1.32, 28: 1.24, 29: 1.32, 30: 1.22, 32: 1.20, 38: 1.95,
         42: 1.54, 56: 2.15, 74: 1.62}


def morse_labels(structures, cutoff: float, seed: int, device) -> list:
    """(energy eV, forces (n, 3) eV/A, stress (6,) eV/A^3 Voigt) per
    (lattice, positions, numbers) structure, as float64 numpy."""
    rng = np.random.default_rng([seed, 7])
    depth, alpha = rng.uniform(0.2, 0.4), rng.uniform(1.4, 1.8)
    radii = torch.zeros(120, dtype=torch.float64, device=device)
    for z, r in RADII.items():
        radii[z] = r
    eye = torch.eye(3, dtype=torch.float64, device=device)
    xs, strains, parts = [], [], []
    for lattice, pos, numbers in structures:
        lat = torch.as_tensor(lattice, device=device)
        x = torch.as_tensor(pos, device=device).requires_grad_(True)
        strain = torch.zeros(3, 3, dtype=torch.float64, device=device, requires_grad=True)
        z = torch.as_tensor(numbers, device=device)
        src, dst, shift = neighbors.neighbor_list(x.detach(), lat, cutoff)
        xd, ld = x @ (eye + strain), lat @ (eye + strain)
        r = torch.linalg.vector_norm(xd[dst] + shift @ ld - xd[src], dim=1)
        r0 = radii[z[src]] + radii[z[dst]]
        pair = depth * ((1 - torch.exp(-alpha * (r - r0))) ** 2 - 1) * cutoff_fn(r, cutoff)
        xs.append(x)
        strains.append(strain)
        parts.append(0.5 * pair.sum())
    energies = torch.stack(parts)
    grads = torch.autograd.grad(energies.sum(), xs + strains)
    out = []
    for b, (lattice, _, _) in enumerate(structures):
        gs = grads[len(xs) + b]
        s = (0.5 * (gs + gs.T) / abs(float(np.linalg.det(lattice)))).cpu().numpy()
        voigt = np.array([s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[2, 0], s[0, 1]])
        out.append((float(energies[b].detach()), (-grads[b]).cpu().numpy(), voigt))
    return out

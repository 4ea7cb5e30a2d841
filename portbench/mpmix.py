"""The ``mp-mix`` structure generator: periodic crystals of six prototypes.

Each structure is a conventional cell of a real compound (lattice constants
at room temperature, from the standard tables) repeated to 64-256 atoms,
strained by a random symmetric strain of at most ``strain`` per component,
with Gaussian noise of ``noise`` Angstrom on every position, wrapped into
the cell. A traffic file names the structures of one batch as a recipe,
``[compound, na, nb, nc]`` per structure; every batch holds that recipe.
The strains are drawn once for each slot of the pool, the same for every
seed: a strain moves whole neighbour shells across the cutoffs (Ge's
second shell lies at 4.0008 A, the three-body cutoff), so a strain drawn
from the seed would change the work. The seed draws the order of the
structures in each batch and the noise.
"""

from __future__ import annotations

import math

import numpy as np

_FCC = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]
_BCC = [[0, 0, 0], [0.5, 0.5, 0.5]]
_HCP = [[1 / 3, 2 / 3, 0.25], [2 / 3, 1 / 3, 0.75]]
_PEROVSKITE = [[0, 0, 0], [0.5, 0.5, 0.5], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]


def _cubic(a):
    return np.eye(3) * a


def _hexagonal(a, c):
    return np.array([[a, 0, 0], [-a / 2, a * math.sqrt(3) / 2, 0], [0, 0, c]])


def _rocksalt(z_a, z_b):
    frac = _FCC + [[x + 0.5, y, z] for x, y, z in _FCC]
    return np.array(frac) % 1.0, [z_a] * 4 + [z_b] * 4


def _diamond(z):
    frac = _FCC + [[x + 0.25, y + 0.25, z_ + 0.25] for x, y, z_ in _FCC]
    return np.array(frac) % 1.0, [z] * 8


# compound: (prototype, lattice (3, 3), fractional sites, atomic numbers)
COMPOUNDS = {
    "Cu": ("fcc", _cubic(3.615), np.array(_FCC), [29] * 4),
    "Al": ("fcc", _cubic(4.050), np.array(_FCC), [13] * 4),
    "Ni": ("fcc", _cubic(3.524), np.array(_FCC), [28] * 4),
    "Fe": ("bcc", _cubic(2.867), np.array(_BCC), [26] * 2),
    "W": ("bcc", _cubic(3.165), np.array(_BCC), [74] * 2),
    "Mo": ("bcc", _cubic(3.147), np.array(_BCC), [42] * 2),
    "Mg": ("hcp", _hexagonal(3.209, 5.211), np.array(_HCP), [12] * 2),
    "Ti": ("hcp", _hexagonal(2.951, 4.686), np.array(_HCP), [22] * 2),
    "Zn": ("hcp", _hexagonal(2.665, 4.947), np.array(_HCP), [30] * 2),
    "NaCl": ("rocksalt", _cubic(5.640), *_rocksalt(11, 17)),
    "MgO": ("rocksalt", _cubic(4.212), *_rocksalt(12, 8)),
    "LiF": ("rocksalt", _cubic(4.027), *_rocksalt(3, 9)),
    "Si": ("diamond", _cubic(5.431), *_diamond(14)),
    "Ge": ("diamond", _cubic(5.658), *_diamond(32)),
    "C": ("diamond", _cubic(3.567), *_diamond(6)),
    "SrTiO3": ("perovskite", _cubic(3.905), np.array(_PEROVSKITE), [38, 22, 8, 8, 8]),
    "BaTiO3": ("perovskite", _cubic(4.000), np.array(_PEROVSKITE), [56, 22, 8, 8, 8]),
}

# Standard atomic weights (amu) of the species above.
MASSES = {3: 6.94, 6: 12.011, 8: 15.999, 9: 18.998, 11: 22.990, 12: 24.305, 13: 26.982,
          14: 28.085, 17: 35.45, 22: 47.867, 26: 55.845, 28: 58.693, 29: 63.546, 30: 65.38,
          32: 72.630, 38: 87.62, 42: 95.95, 56: 137.33, 74: 183.84}


def crystal(compound: str, reps, rng=None, strain: float = 0.0, noise: float = 0.0,
            strain_rng=None):
    """(lattice (3, 3), cartesian positions (n, 3), atomic numbers (n,)),
    float64: ``compound``'s conventional cell repeated ``reps`` times, then
    strained (with ``strain_rng``, by default ``rng``) and jittered with
    ``rng``."""
    _, lat, frac, z = COMPOUNDS[compound]
    na, nb, nc = reps
    grid = np.array([[i, j, k] for i in range(na) for j in range(nb) for k in range(nc)], float)
    frac = ((grid[:, None, :] + frac[None]) / np.array([na, nb, nc])).reshape(-1, 3)
    lattice = lat * np.array([[na], [nb], [nc]], dtype=float)
    numbers = np.tile(np.asarray(z), len(grid))
    strain_rng = rng if strain_rng is None else strain_rng
    if strain_rng is not None and strain:
        eps = strain_rng.uniform(-strain, strain, (3, 3))
        lattice = lattice @ (np.eye(3) + 0.5 * (eps + eps.T))
    pos = frac @ lattice
    if rng is not None and noise:
        pos = pos + noise * rng.standard_normal(pos.shape)
    pos = (pos @ np.linalg.inv(lattice)) % 1.0 @ lattice
    return lattice, pos, numbers


def batches(recipe: list, count: int, seed: int, strain: float, noise: float):
    """``count`` batches, each the structures of ``recipe`` (``[compound,
    na, nb, nc]`` entries) in a seeded order, as lists of (lattice,
    positions, numbers); slot i of batch b has the same strain for every
    seed."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(count):
        order = rng.permutation(len(recipe))
        out.append([crystal(recipe[i][0], recipe[i][1:], rng, strain, noise,
                            np.random.default_rng([b, int(i)])) for i in order])
    return out


def masses(numbers) -> np.ndarray:
    return np.array([MASSES[int(z)] for z in numbers])

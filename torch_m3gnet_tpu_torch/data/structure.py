"""Minimal periodic-crystal structure container (host side, numpy).

Own copy of ``torch_m3gnet_tpu.data.structure``: only what graph
construction needs — a row-wise lattice, cartesian coordinates and atomic
numbers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Structure:
    """A periodic crystal.

    Attributes:
        lattice: (3, 3) float64, row-wise lattice vectors (a1; a2; a3).
        cart_coords: (N, 3) float64 cartesian coordinates in Angstrom.
        atomic_numbers: (N,) int, 1-indexed atomic numbers Z.
        properties: free-form per-structure data (energy, forces, stress, ...).
    """

    lattice: np.ndarray
    cart_coords: np.ndarray
    atomic_numbers: np.ndarray
    properties: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.lattice = np.asarray(self.lattice, dtype=np.float64).reshape(3, 3)
        self.cart_coords = np.asarray(self.cart_coords, dtype=np.float64).reshape(-1, 3)
        self.atomic_numbers = np.asarray(self.atomic_numbers, dtype=np.int64).reshape(-1)
        if self.cart_coords.shape[0] != self.atomic_numbers.shape[0]:
            raise ValueError(
                f"coords ({self.cart_coords.shape[0]}) and atomic numbers "
                f"({self.atomic_numbers.shape[0]}) disagree"
            )

    @classmethod
    def from_frac_coords(
        cls,
        lattice: np.ndarray,
        frac_coords: np.ndarray,
        atomic_numbers: np.ndarray,
        properties: dict | None = None,
    ) -> "Structure":
        lattice = np.asarray(lattice, dtype=np.float64).reshape(3, 3)
        frac = np.asarray(frac_coords, dtype=np.float64).reshape(-1, 3)
        return cls(
            lattice=lattice,
            cart_coords=frac @ lattice,
            atomic_numbers=np.asarray(atomic_numbers),
            properties=dict(properties or {}),
        )

    def __len__(self) -> int:
        return int(self.cart_coords.shape[0])

    @property
    def num_sites(self) -> int:
        return len(self)

    @property
    def frac_coords(self) -> np.ndarray:
        return self.cart_coords @ np.linalg.inv(self.lattice)

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.lattice)))

    def wrap(self) -> "Structure":
        """Return a copy with fractional coordinates wrapped into [0, 1)."""
        frac = self.frac_coords % 1.0
        return Structure(
            lattice=self.lattice.copy(),
            cart_coords=frac @ self.lattice,
            atomic_numbers=self.atomic_numbers.copy(),
            properties=dict(self.properties),
        )

    def supercell(self, reps: tuple[int, int, int]) -> "Structure":
        """Return an (na, nb, nc) supercell (site order: image-major).

        Targets transform for exact periodic replication: ``energy`` is
        extensive (x M images), ``forces`` replicate per image, ``stress`` is
        intensive (unchanged).
        """
        na, nb, nc = reps
        images = np.array(
            [[i, j, k] for i in range(na) for j in range(nb) for k in range(nc)],
            dtype=np.float64,
        )
        shift_cart = images @ self.lattice  # (M, 3)
        coords = (shift_cart[:, None, :] + self.cart_coords[None, :, :]).reshape(-1, 3)
        numbers = np.tile(self.atomic_numbers, len(images))
        new_lattice = self.lattice * np.array([[na], [nb], [nc]], dtype=np.float64)
        props = dict(self.properties)
        m = len(images)
        if props.get("energy") is not None:
            props["energy"] = float(props["energy"]) * m
        if props.get("forces") is not None:
            props["forces"] = np.tile(
                np.asarray(props["forces"]).reshape(-1, 3), (m, 1)
            )
        return Structure(new_lattice, coords, numbers, props)

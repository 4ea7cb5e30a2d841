"""Dataset file readers (host side, numpy and the standard library).

Own copy of ``torch_m3gnet_tpu.data.io``: dependency-free readers for

- pymatgen ``Structure.as_dict()`` JSON (the mlearn datasets),
- P1 CIF strings as pymatgen writes them (the MPF.2021.2.8 block pickles).

Stresses arrive in kbar and become eV/A^3 (1 eV/A^3 = 1602.1766208 kbar).

Stress shear order: the mlearn files hold VASP order [xx, yy, zz, xy, yz,
zx]; the model's Voigt order is [xx, yy, zz, yz, zx, xy], so the correct
gather is ``[0, 1, 2, 4, 5, 3]`` (``shear_order="voigt"``, the default).
``shear_order="reference"`` keeps the upstream loader's literal gather
``[0, 1, 2, 5, 3, 4]``, which lands the shear components permuted; it
exists for byte-level comparisons with that loader.
"""

from __future__ import annotations

import json
import pickle
import re
from typing import Any, Sequence

import numpy as np

from torch_m3gnet_tpu_torch.data.structure import Structure

KBAR_PER_EV_A3 = 1602.1766208

# Z of each element symbol, 1..103.
_ELEMENTS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co Ni "
    "Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb Te I "
    "Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re Os Ir Pt "
    "Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf Es Fm Md No Lr"
).split()
Z_OF = {sym: i + 1 for i, sym in enumerate(_ELEMENTS)}

# VASP [xx, yy, zz, xy, yz, zx] -> model Voigt [xx, yy, zz, yz, zx, xy]
SHEAR_GATHERS = {
    "voigt": [0, 1, 2, 4, 5, 3],
    "reference": [0, 1, 2, 5, 3, 4],
}


def structure_from_pymatgen_dict(d: dict[str, Any]) -> Structure:
    """Parse a pymatgen ``Structure.as_dict()`` payload."""
    lattice = np.asarray(d["lattice"]["matrix"], dtype=np.float64)
    frac = []
    numbers = []
    for site in d["sites"]:
        frac.append(site["abc"])
        sp = site["species"][0]
        label = sp.get("element", sp.get("symbol"))
        numbers.append(Z_OF[re.sub(r"[^A-Za-z]", "", label)])
    return Structure.from_frac_coords(lattice, np.asarray(frac), np.asarray(numbers))


def load_mlearn_json(path: str, shear_order: str = "voigt") -> list[Structure]:
    """Load an mlearn training or test JSON: structures with E/F/S targets
    (``shear_order``: see the module docstring)."""
    gather = SHEAR_GATHERS[shear_order]
    with open(path) as f:
        raw = json.load(f)
    out = []
    for data in raw:
        s = structure_from_pymatgen_dict(data["structure"])
        outputs = data["outputs"]
        s.properties["energy"] = float(outputs["energy"])
        s.properties["forces"] = np.asarray(outputs["forces"], dtype=np.float64)
        vs = np.asarray(outputs["virial_stress"], dtype=np.float64) / KBAR_PER_EV_A3
        s.properties["stress"] = vs[gather]
        out.append(s)
    return out


def _cif_float(tok: str) -> float:
    """A CIF number, without an uncertainty suffix such as 1.234(5)."""
    return float(re.sub(r"\(.*\)", "", tok))


def parse_cif(text: str) -> Structure:
    """Minimal P1 CIF parser: the cell parameters and the fractional
    ``atom_site`` loop, as pymatgen writes them for MPF.2021.2.8 (no
    symmetry expansion beyond P1)."""
    cell = {}
    for key in ("a", "b", "c", "alpha", "beta", "gamma"):
        m = re.search(rf"_cell_length_{key}\s+([\d.()\-Ee+]+)", text) or re.search(
            rf"_cell_angle_{key}\s+([\d.()\-Ee+]+)", text
        )
        if m:
            cell[key] = _cif_float(m.group(1))
    a, b, c = cell["a"], cell["b"], cell["c"]
    al, be, ga = (np.radians(cell[k]) for k in ("alpha", "beta", "gamma"))

    # The standard cell -> cartesian rows a1, a2, a3.
    v1 = np.array([a, 0.0, 0.0])
    v2 = np.array([b * np.cos(ga), b * np.sin(ga), 0.0])
    cx = np.cos(be)
    cy = (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(1.0 - cx * cx - cy * cy, 0.0))
    v3 = np.array([c * cx, c * cy, c * cz])
    lattice = np.stack([v1, v2, v3])

    headers: list[str] = []
    rows: list[list[str]] = []
    in_loop = False
    collecting = False
    for ln in (line.strip() for line in text.splitlines()):
        if ln.startswith("loop_"):
            in_loop = True
            headers = []
            collecting = False
            continue
        if in_loop and ln.startswith("_"):
            headers.append(ln.split()[0])
            collecting = True
            continue
        if collecting and ln and not ln.startswith(("_", "loop_", "#")):
            if "_atom_site_fract_x" in headers:
                rows.append(ln.split())
            continue
        if collecting and not ln:
            in_loop = False
            collecting = False
            headers = []

    if not rows:
        raise ValueError("no atom_site loop found in CIF")
    ix = headers.index("_atom_site_fract_x")
    iy = headers.index("_atom_site_fract_y")
    iz = headers.index("_atom_site_fract_z")
    try:
        isym = headers.index("_atom_site_type_symbol")
    except ValueError:
        isym = headers.index("_atom_site_label")

    frac = []
    numbers = []
    for row in rows:
        frac.append([_cif_float(row[ix]), _cif_float(row[iy]), _cif_float(row[iz])])
        numbers.append(Z_OF[re.sub(r"[^A-Za-z].*$", "", row[isym])])
    return Structure.from_frac_coords(lattice, np.asarray(frac), np.asarray(numbers))


def load_mpf_pickles(
    paths: Sequence[str],
    val_ratio: float = 0.1,
    test_ratio: float = 0.1,
    seed: int = 0,
) -> tuple[list[Structure], list[Structure], list[Structure]]:
    """Load MPF.2021.2.8 block pickles into (train, val, test) structures.

    The split is by material id, before the trajectories are flattened, so
    no trajectory is shared between splits. Each frame is a CIF string or a
    pymatgen dict; stresses (3 x 3, kbar) become Voigt rows in eV/A^3.
    The files are the dataset's own pickles: open only trusted ones.
    """
    raw: dict = {}
    for p in paths:
        with open(p, "rb") as f:
            raw.update(pickle.load(f))

    ids = sorted(raw.keys())
    order = np.random.default_rng(seed).permutation(len(ids))
    n_val = int(len(ids) * val_ratio)
    n_test = int(len(ids) * test_ratio)
    val, test = set(order[:n_val]), set(order[n_val : n_val + n_test])

    out: dict[str, list[Structure]] = {"train": [], "val": [], "test": []}
    for i, mid in enumerate(ids):
        split = "val" if i in val else "test" if i in test else "train"
        data = raw[mid]
        for cif, energy, forces, stress in zip(
            data["structure"], data["energy"], data["force"], data["stress"]
        ):
            s = parse_cif(cif) if isinstance(cif, str) else structure_from_pymatgen_dict(cif)
            s.properties["energy"] = float(energy)
            s.properties["forces"] = np.asarray(forces, dtype=np.float64)
            vs = np.asarray(stress, dtype=np.float64) / KBAR_PER_EV_A3
            s.properties["stress"] = np.array(
                [vs[0, 0], vs[1, 1], vs[2, 2], vs[1, 2], vs[2, 0], vs[0, 1]]
            )
            out[split].append(s)
    return out["train"], out["val"], out["test"]

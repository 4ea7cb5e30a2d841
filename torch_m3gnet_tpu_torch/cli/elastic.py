"""Elastic constants, Gamma phonons and the equation of state of one
structure from the port's potential, on the card, by exact autodiff (nested
``torch.autograd.grad``: no displacement supercells, no finite-difference
steps).

Input: one structure as JSON ({"lattice": 3x3, "frac_coords"|"cart_coords",
"atomic_numbers", optional "masses_amu"}; a list gives its first). Output:
JSON with the 6x6 elastic matrix (GPa), the Voigt bulk modulus, Gamma
frequencies (THz) unless ``--skip-phonons``, and with ``--eos`` the E(V)
curve and its Birch-Murnaghan fit.

Usage:
    python -m torch_m3gnet_tpu_torch.cli.elastic --structure cu.json \
        --checkpoint runs/cu/checkpoints/best --eos
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from torch_m3gnet_tpu_torch.cli.common import add_model_args, load_potential, structure_from_dict
from torch_m3gnet_tpu_torch.data.graph import pack_structures
from torch_m3gnet_tpu_torch.simulate import (
    birch_murnaghan_fit,
    bulk_modulus_voigt,
    elastic_tensor,
    energy_volume_curve,
    gamma_phonons,
)

# amu per Z (1..94), standard atomic weights; index 0 unused.
_MASSES = [0.0,
    1.008, 4.003, 6.94, 9.012, 10.81, 12.011, 14.007, 15.999, 18.998, 20.18,
    22.99, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948, 39.098,
    40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933, 58.693,
    63.546, 65.38, 69.723, 72.63, 74.922, 78.971, 79.904, 83.798, 85.468,
    87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.906, 106.42,
    107.868, 112.414, 114.818, 118.71, 121.76, 127.6, 126.904, 131.293,
    132.905, 137.327, 138.905, 140.116, 140.908, 144.242, 145.0, 150.36,
    151.964, 157.25, 158.925, 162.5, 164.93, 167.259, 168.934, 173.045,
    174.967, 178.486, 180.948, 183.84, 186.207, 190.23, 192.217, 195.084,
    196.967, 200.592, 204.38, 207.2, 208.98, 209.0, 210.0, 222.0, 223.0,
    226.0, 227.0, 232.038, 231.036, 238.029, 237.0, 244.0,
]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--structure", required=True, help="JSON file (see above)")
    ap.add_argument("--skip-phonons", action="store_true")
    ap.add_argument(
        "--eos", action="store_true",
        help="also compute the E(V) curve and a Birch-Murnaghan fit "
        "(reports E0/V0/B0/B0'; fails gracefully when the sampled window "
        "holds no minimum)",
    )
    ap.add_argument("--eos-strain", type=float, default=0.04)
    ap.add_argument("--eos-points", type=int, default=13)
    add_model_args(ap)
    args = ap.parse_args(argv)
    config, pot = load_potential(args)

    with open(args.structure) as f:
        d = json.load(f)
    if isinstance(d, list):
        d = d[0]
    s = structure_from_dict(d)
    batch = pack_structures([s], config.cutoff, config.threebody_cutoff)

    c = elastic_tensor(pot, batch, gpa=True)
    out = {
        "elastic_gpa": np.round(c, 6).tolist(),
        "bulk_modulus_voigt_gpa": round(bulk_modulus_voigt(c), 6),
    }
    if not args.skip_phonons:
        masses = d.get("masses_amu", [_MASSES[int(z)] for z in s.atomic_numbers])
        ph = gamma_phonons(pot, batch, masses)
        out["gamma_frequencies_thz"] = np.round(ph["frequencies_thz"], 6).tolist()
    if args.eos:
        vols, energies = energy_volume_curve(
            pot, batch,
            strains=np.linspace(-args.eos_strain, args.eos_strain, args.eos_points),
        )
        out["eos_volumes_a3"] = np.round(vols, 6).tolist()
        out["eos_energies_ev"] = np.round(energies, 8).tolist()
        try:
            out["birch_murnaghan"] = {
                k: round(v, 6) for k, v in birch_murnaghan_fit(vols, energies).items()
            }
        except ValueError as exc:
            out["birch_murnaghan"] = {"error": str(exc)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

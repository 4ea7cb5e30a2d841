"""Batched structure relaxation with the port's potential, on the card.

FIRE (default) or L-BFGS from ``simulate.relax``, all structures in one
padded batch; ``--relax-cell`` relaxes the cell with the atoms. With
``--checkpoint`` the potential carries the sidecar's elemental energies and
energy scale, as ``predict`` does.

Input: a JSON file of structures, each {"lattice": 3x3, "frac_coords": Nx3,
"atomic_numbers": [...]} (or "cart_coords"). Output: relaxed structures with
final energies and max-force, printed as JSON.

Usage:
    python -m torch_m3gnet_tpu_torch.cli.relax --structures cells.json \\
        --checkpoint runs/cu/checkpoints/best --relax-cell
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from torch_m3gnet_tpu_torch.cli.common import add_model_args, load_potential, load_structures
from torch_m3gnet_tpu_torch.simulate import FireConfig, LbfgsConfig, relax_structures


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--structures", required=True, help="JSON list of structures")
    ap.add_argument("--fmax", type=float, default=0.05)
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--optimizer", choices=("fire", "lbfgs"), default="fire")
    ap.add_argument("--relax-cell", action="store_true",
                    help="optimize the cell strain jointly with the positions")
    add_model_args(ap)
    args = ap.parse_args(argv)
    config, pot = load_potential(args)
    structures = load_structures(args.structures)

    relaxed, energies, fmax = relax_structures(
        pot,
        structures,
        config.cutoff,
        config.threebody_cutoff,
        (LbfgsConfig if args.optimizer == "lbfgs" else FireConfig)(
            max_steps=args.max_steps, fmax=args.fmax, relax_cell=args.relax_cell
        ),
    )
    out = [
        {
            "lattice": s.lattice.tolist(),
            "cart_coords": s.cart_coords.tolist(),
            "atomic_numbers": s.atomic_numbers.tolist(),
            "energy": float(e),
            "fmax": float(fm),
        }
        for s, e, fm in zip(relaxed, energies, fmax)
    ]
    print(json.dumps(out))


if __name__ == "__main__":
    main()

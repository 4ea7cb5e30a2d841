"""Potential evaluation: structures in, energy/forces/stress out, on the card.

The structures are packed into padded batches of ``--batch-size`` and
evaluated by the port's potential. Input: a JSON list of structures, each
{"lattice": 3x3, "frac_coords": Nx3, "atomic_numbers": [...]} (or
"cart_coords"), or an mlearn-format JSON file (``--format mlearn``). Output:
per-structure {energy, energy_per_atom, forces, stress_voigt, num_atoms} JSON
on stdout, with the per-atom ``magmom`` (Bohr magnetons) for a model that
predicts them (CHGNet). The batches carry what the model reads from pack
time (CHGNet's bond pairs).

Usage:
    python -m torch_m3gnet_tpu_torch.cli.predict --structures cells.json \\
        --checkpoint runs/cu/checkpoints/best --config configs/mlearn_Cu.yaml
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from torch_m3gnet_tpu_torch.cli.common import add_model_args, load_potential, load_structures
from torch_m3gnet_tpu_torch.data.graph import pack_structures


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--structures", required=True, help="input file (see above)")
    ap.add_argument("--format", choices=("json", "mlearn"), default="json")
    ap.add_argument("--batch-size", type=int, default=32)
    add_model_args(ap)
    args = ap.parse_args(argv)
    config, pot = load_potential(args)
    structures = load_structures(args.structures, args.format)
    bond_pairs = "edge_reverse" in pot.model.batch_index

    results = []
    for lo in range(0, len(structures), args.batch_size):
        chunk = structures[lo : lo + args.batch_size]
        batch = pack_structures(chunk, config.cutoff, config.threebody_cutoff,
                                bond_pairs=bond_pairs)
        with torch.no_grad():
            out = pot(batch)
        magmom = None if out.magmom is None else out.magmom.detach().cpu().double().numpy()
        energy, per_atom, forces, stress = (
            getattr(out, k).detach().cpu().double().numpy()
            for k in ("energy", "energy_per_atom", "forces", "stress"))
        for gi, s in enumerate(chunk):
            sel = (batch.node_graph == gi) & batch.node_mask
            results.append({
                "energy": float(energy[gi]),
                "energy_per_atom": float(per_atom[gi]),
                "forces": forces[sel].tolist(),
                "stress_voigt": stress[gi].tolist(),
                "num_atoms": len(s),
                **({} if magmom is None else {"magmom": magmom[sel].tolist()}),
            })
    print(json.dumps(results))


if __name__ == "__main__":
    main()

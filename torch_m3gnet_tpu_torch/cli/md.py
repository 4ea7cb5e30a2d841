"""Batched molecular dynamics with the port's potential, on the card.

NVE (velocity Verlet), NVT (Langevin BAOAB) or NPT (BAOAB with a Berendsen
barostat) from ``simulate.md``, all structures in one padded batch. With
``--checkpoint`` the potential carries the sidecar's elemental energies and
energy scale, as ``predict`` does.

Input: a JSON file of structures, each {"lattice": 3x3, "frac_coords": Nx3,
"atomic_numbers": [...]} (or "cart_coords"). Output: final structures with
velocities plus per-step energy/temperature series (and, under NPT,
pressure and volume), printed as JSON. ``--traj-out`` writes each
structure's frames as extended XYZ; under NPT each frame's cell is the
initial one scaled by (V_t / V_0)^(1/3) (the barostat scales isotropically).

Usage:
    python -m torch_m3gnet_tpu_torch.cli.md --structures cells.json \\
        --checkpoint runs/cu/checkpoints/best --ensemble npt --steps 1000
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from torch_m3gnet_tpu_torch.cli.common import add_model_args, load_potential, load_structures
from torch_m3gnet_tpu_torch.simulate import MDConfig, run_md, write_extxyz


def npt_lattices(structure, volumes: np.ndarray) -> np.ndarray:
    """(n_frames, 3, 3) cells of an NPT run: the initial cell scaled by
    (V_t / V_0)^(1/3), from the run's volume log (n_frames,)."""
    v0 = abs(np.linalg.det(structure.lattice))
    mu = (np.asarray(volumes) / v0) ** (1.0 / 3.0)
    return structure.lattice[None] * mu[:, None, None]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--structures", required=True, help="JSON list of structures")
    ap.add_argument("--ensemble", choices=("nve", "nvt", "npt"), default="nvt")
    ap.add_argument("--temperature", type=float, default=300.0, help="K")
    ap.add_argument("--friction", type=float, default=0.01, help="Langevin gamma, 1/fs")
    ap.add_argument("--pressure", type=float, default=0.0, help="NPT target, GPa")
    ap.add_argument("--tau-p", type=float, default=500.0, help="barostat tau, fs")
    ap.add_argument("--compressibility", type=float, default=1e-2,
                    help="barostat coupling, 1/GPa")
    ap.add_argument("--dt", type=float, default=1.0, help="fs")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--rebuild-every", type=int, default=20)
    ap.add_argument(
        "--traj-out",
        default=None,
        help="write per-structure extended-XYZ trajectories to "
        "<traj-out>.<i>.extxyz (records every step)",
    )
    add_model_args(ap)
    args = ap.parse_args(argv)
    config, pot = load_potential(args)
    structures = load_structures(args.structures)

    res = run_md(
        pot,
        structures,
        config.cutoff,
        config.threebody_cutoff,
        MDConfig(
            dt=args.dt,
            n_steps=args.steps,
            ensemble=args.ensemble,
            temperature=args.temperature,
            friction=args.friction,
            pressure=args.pressure,
            tau_p=args.tau_p,
            compressibility=args.compressibility,
            rebuild_every=args.rebuild_every,
            seed=args.seed,
            record_trajectory=args.traj_out is not None,
        ),
    )

    if args.traj_out is not None:
        for i, (s, traj) in enumerate(zip(structures, res.trajectories)):
            lattices = None if res.volumes is None else npt_lattices(s, res.volumes[:, i])
            write_extxyz(
                f"{args.traj_out}.{i}.extxyz", s, traj,
                energies=res.energies[:, i], times=res.times, lattices=lattices,
            )
    out = {
        "structures": [
            {
                "lattice": s.lattice.tolist(),
                "cart_coords": s.cart_coords.tolist(),
                "atomic_numbers": s.atomic_numbers.tolist(),
                "velocities": s.properties["velocities"].tolist(),
            }
            for s in res.structures
        ],
        "times_fs": res.times.tolist(),
        "potential_energy_ev": res.energies.tolist(),
        "kinetic_energy_ev": res.kinetic.tolist(),
        "temperature_k": res.temperatures.tolist(),
    }
    if res.pressures is not None:
        out["pressure_gpa"] = res.pressures.tolist()
        out["volume_a3"] = res.volumes.tolist()
    print(json.dumps(out))


if __name__ == "__main__":
    main()

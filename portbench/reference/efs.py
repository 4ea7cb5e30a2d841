"""Energy, forces and stress of structures by the plain reference model.

Forces are -dE/dx and the stress is (1/V) dE/d(strain), symmetrised, in
Voigt order [xx, yy, zz, yz, zx, xy]: autograd through a strain applied to
positions and lattice alike, so no pair-force bookkeeping is assumed.
Structures are concatenated into one graph per call; callers pass blocks
of structures so that a call fits on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference import model, neighbors


@dataclass
class Cell:
    """One structure: positions (n, 3), lattice rows (3, 3), 0-based species."""

    pos: torch.Tensor
    lattice: torch.Tensor
    types: torch.Tensor


def edge_list(cell: Cell, cutoff: float):
    return neighbors.neighbor_list(cell.pos, cell.lattice, cutoff)


def efs(weights: dict, cfg: dict, consts: dict, cells: list, elemental, energy_scale: float,
        create_graph: bool = False, lists: list | None = None):
    """(energy (B,), forces [(n_b, 3)], stress (B, 6)) of ``cells``.

    ``lists``: one (src, dst, shift) per cell, frozen (a skin list kept
    between rebuilds); by default each cell's list at the two-body cutoff.
    Triplets are taken from the current distances in either case."""
    dev = cells[0].pos.device
    dtype = weights["model.edge_init.kernel"].dtype
    pos_l, strain_l = [], []
    srcs, dsts, shifts, graphs_e, types, node_graph = [], [], [], [], [], []
    off = 0
    for b, cell in enumerate(cells):
        n = cell.pos.shape[0]
        src, dst, shift = lists[b] if lists is not None else edge_list(cell, cfg["cutoff"])
        pos = cell.pos.detach().to(dtype).requires_grad_(True)
        pos_l.append(pos)
        strain_l.append(torch.zeros(3, 3, dtype=dtype, device=dev, requires_grad=True))
        srcs.append(src + off)
        dsts.append(dst + off)
        shifts.append(shift.to(dtype))
        graphs_e.append(torch.full_like(src, b))
        types.append(cell.types)
        node_graph.append(torch.full((n,), b, dtype=torch.long, device=dev))
        off += n
    eye = torch.eye(3, dtype=dtype, device=dev)
    pos_d = torch.cat([p @ (eye + s) for p, s in zip(pos_l, strain_l)])
    lat_d = torch.stack([c.lattice.to(dtype) @ (eye + s) for c, s in zip(cells, strain_l)])
    src, dst, shift, ge = (torch.cat(x) for x in (srcs, dsts, shifts, graphs_e))
    r_vec = pos_d[dst] + torch.einsum("ek,ekl->el", shift, lat_d[ge]) - pos_d[src]
    dist = torch.linalg.vector_norm(r_vec, dim=1).detach()
    trip = neighbors.triplets(src, dist, off, cfg["threebody_cutoff"])
    energy = model.energies(weights, cfg, consts, torch.cat(types), torch.cat(node_graph),
                            len(cells), src, dst, r_vec, trip,
                            elemental.to(dtype), energy_scale)
    grads = torch.autograd.grad(energy.sum(), pos_l + strain_l, create_graph=create_graph)
    forces = [-g for g in grads[: len(cells)]]
    stress = []
    for cell, g in zip(cells, grads[len(cells):]):
        vol = torch.abs(torch.linalg.det(cell.lattice.to(dtype)))
        s = 0.5 * (g + g.T) / vol
        stress.append(torch.stack([s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[2, 0], s[0, 1]]))
    return energy, forces, torch.stack(stress)

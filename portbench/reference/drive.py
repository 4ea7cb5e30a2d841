"""The reference's three uses: E/F/S of structures, an NVE chunk, and the
first training steps, each in blocks that fit, in float64 (the check) or
in float32 with TF32 matrix products (the lower-precision control).

Everything here takes the benchmark's own inputs (structures, seeded
weights, labels) and, for the MD chunk that the check follows, the state
the program reached; nothing the program derived from them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import efs as ref_efs
from portbench.reference import model, neighbors

# 1 eV / (Angstrom amu) in Angstrom / fs^2 (CODATA 2018: eV, atomic mass unit).
FORCE_TO_ACC = 1.602176634e-19 / (1e-10 * 1.66053906660e-27) * 1e10 / 1e30


@contextlib.contextmanager
def precision(name: str):
    """``"float64"``: the reference; ``"tf32"``: float32 with TF32 matrix
    products, the control one step below the configuration's float32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.float64 if name == "float64" else torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def cast(weights: dict, dtype, grad: bool = False) -> dict:
    return {k: v.detach().to(dtype).clone().requires_grad_(grad) for k, v in weights.items()}


def cell(structure, device, dtype=torch.float64) -> ref_efs.Cell:
    lattice, pos, numbers = structure
    return ref_efs.Cell(torch.as_tensor(pos, dtype=dtype, device=device),
                        torch.as_tensor(lattice, dtype=dtype, device=device),
                        torch.as_tensor(np.asarray(numbers) - 1, device=device))


def blocks(items, block_atoms: int, atoms=lambda s: len(s[2])):
    """Consecutive runs of ``items`` (structures, or what ``atoms`` counts
    the atoms of) of about ``block_atoms`` atoms."""
    out, cur, n = [], [], 0
    for s in items:
        cur.append(s)
        n += atoms(s)
        if n >= block_atoms:
            out.append(cur)
            cur, n = [], 0
    return out + ([cur] if cur else [])


def efs(weights, cfg, structures, elemental, prec: str = "float64", block_atoms: int = 2048):
    """[(energy, forces (n, 3), stress (6,))] per structure, float64 numpy."""
    dev = next(iter(weights.values())).device
    consts = model.basis_constants(cfg)
    out = []
    with precision(prec) as dtype:
        w = cast(weights, dtype)
        elem = torch.as_tensor(elemental, device=dev)
        for block in blocks(structures, block_atoms):
            cells = [cell(s, dev) for s in block]
            energy, forces, stress = ref_efs.efs(w, cfg, consts, cells, elem, cfg["energy_scale"])
            out += [(float(e.detach()), f.detach().double().cpu().numpy(),
                     s.detach().double().cpu().numpy())
                    for e, f, s in zip(energy, forces, stress)]
    return out


def md_chunk(weights, cfg, structure, velocities, masses, elemental, md: dict,
             prec: str = "float64"):
    """NVE velocity Verlet for ``md["rebuild_every"]`` steps of ``md["dt"]``
    fs from ``structure`` with ``velocities`` (A/fs), over the pair list
    at cutoff + skin taken at the start and kept (the configuration's skin
    list), the triplets taken from the current distances. Returns
    (positions, velocities, potential energy of each step), float64."""
    lattice, pos, numbers = structure
    dev = next(iter(weights.values())).device
    consts = model.basis_constants(cfg)
    with precision(prec) as dtype:
        w = cast(weights, dtype)
        elem = torch.as_tensor(elemental, device=dev)
        c = cell(structure, dev)
        pair_list = neighbors.neighbor_list(c.pos, c.lattice, cfg["cutoff"] + md["skin"])
        m = torch.as_tensor(masses, dtype=dtype, device=dev)[:, None]
        x = c.pos.to(dtype)
        v = torch.as_tensor(velocities, dtype=dtype, device=dev)
        c = ref_efs.Cell(x, c.lattice, c.types)

        def force(x):
            e, f, _ = ref_efs.efs(w, cfg, consts, [ref_efs.Cell(x, c.lattice, c.types)], elem,
                                  cfg["energy_scale"], lists=[pair_list])
            return f[0].detach(), float(e[0].detach())

        dt = md["dt"]
        f, _ = force(x)
        energies = []
        for _ in range(md["rebuild_every"]):
            v = v + 0.5 * dt * f / m * FORCE_TO_ACC
            x = x + dt * v
            f, e = force(x)
            v = v + 0.5 * dt * f / m * FORCE_TO_ACC
            energies.append(e)
    return x.double().cpu().numpy(), v.double().cpu().numpy(), np.array(energies)


def train_steps(weights, cfg, batches, elemental, steps: int, prec: str = "float64",
                block_atoms: int = 2048):
    """``steps`` training steps from ``weights`` on ``batches`` (lists of
    (structure, (energy, forces, stress)) label pairs): the loss of the
    configuration (weighted mean squared errors of energy per atom, force
    components and stress components), its weights' gradient through the
    forces' and stress' own gradients, and plain Adam. Returns (losses,
    first gradient, weights after the steps), leaves by name, float64."""
    dev = next(iter(weights.values())).device
    consts = model.basis_constants(cfg)
    b1, b2, eps, lr = 0.9, 0.999, cfg["adam_eps"], cfg["learning_rate"]
    with precision(prec) as dtype:
        w = cast(weights, dtype, grad=True)
        elem = torch.as_tensor(elemental, device=dev)
        mom = {k: torch.zeros_like(v) for k, v in w.items()}
        sq = {k: torch.zeros_like(v) for k, v in w.items()}
        losses, first = [], None
        for t, batch in enumerate(batches[:steps], start=1):
            n_graphs = len(batch)
            n_atoms = sum(len(s[2]) for s, _ in batch)
            grads = {k: torch.zeros_like(v) for k, v in w.items()}
            total = 0.0
            for block in blocks(batch, block_atoms, lambda p: len(p[0][2])):
                cells = [cell(s, dev) for s, _ in block]
                energy, forces, stress = ref_efs.efs(w, cfg, consts, cells, elem,
                                                     cfg["energy_scale"], create_graph=True)
                n = torch.tensor([len(s[2]) for s, _ in block], dtype=dtype, device=dev)
                e_lab = torch.tensor([lab[0] for _, lab in block], dtype=dtype, device=dev)
                f_lab = torch.cat([torch.as_tensor(lab[1], dtype=dtype, device=dev)
                                   for _, lab in block])
                s_lab = torch.stack([torch.as_tensor(lab[2], dtype=dtype, device=dev)
                                     for _, lab in block])
                loss = (cfg["energy_weight"] * ((energy - e_lab) / n).pow(2).sum() / n_graphs
                        + cfg["force_weight"] * (torch.cat(forces) - f_lab).pow(2).sum()
                        / (3 * n_atoms)
                        + cfg["stress_weight"] * (stress - s_lab).pow(2).sum() / (6 * n_graphs))
                g = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
                for k, gk in zip(w, g):
                    if gk is not None:
                        grads[k] += gk
                total += float(loss.detach())
            losses.append(total)
            if first is None:
                first = {k: g.double().clone() for k, g in grads.items()}
            with torch.no_grad():
                for k in w:
                    mom[k].mul_(b1).add_((1 - b1) * grads[k])
                    sq[k].mul_(b2).add_((1 - b2) * grads[k] * grads[k])
                    m_hat = mom[k] / (1 - b1**t)
                    v_hat = sq[k] / (1 - b2**t)
                    w[k] -= lr * m_hat / (torch.sqrt(v_hat) + eps)
    return losses, first, {k: v.detach().double() for k, v in w.items()}


def leaf_norm_gap(program: dict, reference: dict) -> float:
    """Worst leaf of |‖p‖ - ‖r‖| / max(‖r‖, the median leaf's ‖r‖): the gap
    between the two norms, not the norm of the difference."""
    ref = {k: float(torch.linalg.vector_norm(r)) for k, r in reference.items()}
    med = float(np.median(list(ref.values())))
    return max(abs(float(torch.linalg.vector_norm(program[k].double().to(r.device))) - ref[k])
               / max(ref[k], med) for k, r in reference.items())


def max_rel(got, want) -> float:
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def min_image(diff, lattice):
    frac = diff @ np.linalg.inv(lattice)
    return (frac - np.round(frac)) @ lattice

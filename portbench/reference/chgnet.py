"""Plain CHGNet in PyTorch: the benchmark's reference for the CHGNet cells.

The copy, for the card, of the repository's plain CHGNet reference: the
paper's Methods (Deng et al., Nat. Mach. Intell. 5, 1031 (2023),
arXiv:2302.14231) in plain ``torch``, row-major, with nothing of the
program: the reference's own periodic neighbour search and angle
enumeration (``neighbors.py``, the angles at the bond-graph cutoff), one
feature per undirected bond (a bond table by ``torch.unique`` of a
canonical key), ``index_add`` sums, a LayerNorm written out, and autograd
for forces (-dE/dx) and stress ((1/V) dE/d strain, the strain applied to
positions and lattice alike). Structures run in blocks of about
``block_atoms`` atoms, each block one concatenated graph, in float64 (the
check) or in float32 with TF32 products (the control), as ``drive.efs``.

Weights are the benchmark's dict (``kinds/chgnet_screen.py`` ``layout``) by
the program's ``state_dict`` names.

Departures from the paper, each one line:
- the angle is atan2(|r1 x r2|, r1 . r2), not acos of the cosine (the same
  angle; acos has no derivative at pi);
- the angle update after the last bond conv is left out: its output feeds
  nothing (the released code computes it and discards it);
- the values the paper leaves open are the configuration's ``assumed``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from portbench.reference import drive, neighbors

ENVELOPE_P = 8
LN_EPS = 1e-5


def bond_ids(src, dst, shift):
    """(E,) bond id of each directed edge: i->j at S and j->i at -S share
    one (the smaller of the two directions' codes, numbered by
    ``torch.unique``)."""
    s = torch.round(shift).long()
    n = int(torch.maximum(src.max(), dst.max())) + 1
    span = int(s.abs().max()) if s.numel() else 0
    width = 2 * span + 1

    def code(a, b, sh):
        c = a * n + b
        for k in range(3):
            c = c * width + sh[:, k] + span
        return c

    key = torch.minimum(code(src, dst, s), code(dst, src, -s))
    return torch.unique(key, return_inverse=True)[1]


def rbf(w, name, r, cutoff):
    u = r / cutoff
    p = ENVELOPE_P
    env = (1 - (p + 1) * (p + 2) / 2 * u**p + p * (p + 2) * u ** (p + 1)
           - p * (p + 1) / 2 * u ** (p + 2))
    env = torch.where(u < 1, env, torch.zeros_like(env))
    f = w[f"{name}.frequencies"]
    return (math.sqrt(2 / cutoff) * torch.sin(f[None] * r[:, None] / cutoff) / r[:, None]
            * env[:, None])


def fourier(theta, order):
    k = torch.arange(1, order + 1, dtype=theta.dtype, device=theta.device)
    kt = theta[:, None] * k[None]
    const = torch.full((theta.shape[0], 1), 1 / math.sqrt(2), dtype=theta.dtype,
                       device=theta.device)
    return torch.cat([const, torch.sin(kt), torch.cos(kt)], 1) / math.sqrt(math.pi)


def linear(w, name, x):
    y = x @ w[f"{name}.kernel"]
    return y + w[f"{name}.bias"] if f"{name}.bias" in w else y


def layer_norm(x, weight, bias):
    mean = x.mean(1, keepdim=True)
    var = ((x - mean) ** 2).mean(1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * weight + bias


def phi(w, name, x):
    """SiLU(LN(core(x))) * sigmoid(LN(gate(x))), each stack Linear (SiLU
    Linear)*."""
    out = []
    for part in ("core", "gate"):
        depth = sum(1 for k in w if k.startswith(f"{name}.{part}_") and k.endswith(".kernel"))
        h = x
        for i in range(depth):
            h = linear(w, f"{name}.{part}_{i}", h)
            if i < depth - 1:
                h = F.silu(h)
        out.append(layer_norm(h, w[f"{name}.{part}_norm.weight"], w[f"{name}.{part}_norm.bias"]))
    return F.silu(out[0]) * torch.sigmoid(out[1])


def forward(w, cfg, types, node_graph, num_graphs, src, dst, bond, r_vec, e1, e2, elemental):
    """(energy per graph (B,), magnetic moment per atom (N,))."""
    w = {k.removeprefix("model."): v for k, v in w.items()}
    dev = r_vec.device
    num_bonds = int(bond.max()) + 1
    rep = torch.zeros(num_bonds, dtype=torch.long, device=dev).index_put_(
        (bond,), torch.arange(len(bond), device=dev))  # one directed edge a bond
    r_bond = torch.linalg.vector_norm(r_vec[rep], dim=1)
    basis_ag = rbf(w, "rbf_ag", r_bond, cfg["cutoff"])
    basis_bg = rbf(w, "rbf_bg", r_bond, cfg["threebody_cutoff"])
    e = basis_ag @ w["bond_embedding.kernel"]  # (U, D)
    w_ag = basis_ag @ w["bond_weights_ag.kernel"]
    w_bg = basis_bg @ w["bond_weights_bg.kernel"]
    u1, u2 = r_vec[e1], r_vec[e2]
    theta = torch.atan2(torch.linalg.vector_norm(torch.linalg.cross(u1, u2), dim=1),
                        (u1 * u2).sum(1))
    a = fourier(theta, cfg["num_angular"] // 2) @ w["angle_embedding.kernel"]  # (T, D)
    b1, b2, centre = bond[e1], bond[e2], src[e1]
    v = w["atom_embedding.embedding"][types]
    convs = cfg["num_blocks"]
    magmom = None
    for t in range(convs):
        msg = phi(w, f"atom_conv_{t}.phi", torch.cat([v[src], v[dst], e[bond]], 1)) * w_ag[bond]
        v = v + linear(w, f"atom_conv_{t}.out", torch.zeros_like(v).index_add(0, src, msg))
        if t == convs - 2:
            magmom = torch.abs(linear(w, "site_wise", v)[:, 0])
        if t == convs - 1:
            break
        upd = phi(w, f"bond_conv_{t}.phi", torch.cat([e[b1], e[b2], a, v[centre]], 1))
        upd = upd * w_bg[b1] * w_bg[b2]
        e = e + linear(w, f"bond_conv_{t}.out", torch.zeros_like(e).index_add(0, b1, upd))
        if t < convs - 2:
            a = a + phi(w, f"angle_update_{t}.phi", torch.cat([e[b1], e[b2], a, v[centre]], 1))
    h = v
    depth = sum(1 for k in w if k.startswith("readout.") and k.endswith(".kernel"))
    for i in range(depth):
        h = linear(w, f"readout.{i}", h)
        if i < depth - 1:
            h = F.silu(h)
    per_atom = h[:, 0] + elemental[types]
    energy = torch.zeros(num_graphs, dtype=per_atom.dtype, device=dev).index_add(
        0, node_graph, per_atom)
    return energy, magmom


def block_efs(w, cfg, cells, elemental):
    """[(energy, forces (n, 3), stress (6,), magmom (n,))] of one block of
    ``drive.cell`` structures, one concatenated graph."""
    dtype = next(iter(w.values())).dtype
    dev = cells[0].pos.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    pos_l, strain_l, lists, offs = [], [], [], []
    off = 0
    for c in cells:
        pos_l.append(c.pos.detach().to(dtype).requires_grad_(True))
        strain_l.append(torch.zeros(3, 3, dtype=dtype, device=dev, requires_grad=True))
        lists.append(neighbors.neighbor_list(c.pos, c.lattice, cfg["cutoff"]))
        offs.append(off)
        off += c.pos.shape[0]
    src = torch.cat([lst[0] + o for lst, o in zip(lists, offs)])
    dst = torch.cat([lst[1] + o for lst, o in zip(lists, offs)])
    shift = torch.cat([lst[2] for lst in lists]).to(dtype)
    graph_e = torch.cat([torch.full_like(lst[0], b) for b, lst in enumerate(lists)])
    pos_d = torch.cat([p @ (eye + s) for p, s in zip(pos_l, strain_l)])
    lat_d = torch.stack([c.lattice.to(dtype) @ (eye + s) for c, s in zip(cells, strain_l)])
    r_vec = pos_d[dst] + torch.einsum("ek,ekl->el", shift, lat_d[graph_e]) - pos_d[src]
    e1, e2 = neighbors.triplets(src, torch.linalg.vector_norm(r_vec, dim=1).detach(), off,
                                cfg["threebody_cutoff"])
    types = torch.cat([c.types for c in cells])
    node_graph = torch.cat([torch.full((c.pos.shape[0],), b, dtype=torch.long, device=dev)
                            for b, c in enumerate(cells)])
    energy, magmom = forward(w, cfg, types, node_graph, len(cells), src, dst,
                             bond_ids(src, dst, shift), r_vec, e1, e2, elemental.to(dtype))
    grads = torch.autograd.grad(energy.sum(), pos_l + strain_l)
    out = []
    for b, c in enumerate(cells):
        vol = torch.abs(torch.linalg.det(c.lattice.to(dtype)))
        g = grads[len(cells) + b]
        s = 0.5 * (g + g.T) / vol
        n = c.pos.shape[0]
        out.append((float(energy[b].detach()), -grads[b].detach().double().cpu().numpy(),
                    torch.stack([s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[2, 0], s[0, 1]])
                    .detach().double().cpu().numpy(),
                    magmom[offs[b]:offs[b] + n].detach().double().cpu().numpy()))
    return out


def efs(weights, cfg, structures, elemental, prec: str = "float64", block_atoms: int = 2048):
    """[(energy, forces (n, 3), stress (6,), magnetic moments (n,))] per
    structure, float64 numpy; ``prec`` as ``drive.precision``."""
    dev = next(iter(weights.values())).device
    out = []
    with drive.precision(prec) as dtype:
        w = drive.cast(weights, dtype)
        elem = torch.as_tensor(np.asarray(elemental), device=dev)
        for block in drive.blocks(structures, block_atoms):
            out += block_efs(w, cfg, [drive.cell(s, dev) for s in block], elem)
    return out

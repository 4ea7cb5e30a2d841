"""Plain CHGNet in PyTorch: the tests' reference for ``models.chgnet``.

Written from the paper's Methods (Deng et al., Nat. Mach. Intell. 5, 1031
(2023), arXiv:2302.14231) in plain ``torch``, row-major, float64 as the
tests call it, with nothing of the port: its own periodic neighbour search
and angle enumeration, one feature per undirected bond (a bond table made
by ``torch.unique``), ``index_add`` sums over angles and edges, a LayerNorm
written out, and autograd for forces (-dE/dx) and stress ((1/V) dE/d
strain, strain applied to positions and lattice alike).

Weights are the program's ``state_dict`` by name (``model.<block>...``);
``depth`` of each gated MLP is read from the names present.

Departures from the paper, each one line:
- the angle is atan2(|r1 x r2|, r1 . r2), not acos of the cosine (the same
  angle; acos has no derivative at pi, which a bond along a lattice vector
  and its image reach exactly);
- the angle update after the last bond conv is left out: its output feeds
  nothing (the released code computes it and discards it);
- the values the paper leaves open follow the released code, as the
  program's configuration lists them under ``assumed``: a LayerNorm at the
  end of each of phi's twin stacks, hidden width 64 in the atom and bond
  convs' phi and none in the angle update's, an envelope of degree 8 on
  both radial bases, separate bond weights for the atom graph (5 A basis)
  and the bond graph (3 A basis), each a linear map of its basis, and a
  readout MLP of hidden widths (64, 64, 64).
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

ENVELOPE_P = 8
LN_EPS = 1e-5


def neighbor_list(pos, lattice, cutoff):
    """(src, dst, shift (E, 3)) of every pair i, j, image S with
    0 < |x_j + S L - x_i| <= cutoff, src ascending: brute force over the
    images that can reach the cutoff."""
    recip = torch.linalg.inv(lattice).T
    reach = [math.ceil(cutoff * float(torch.linalg.vector_norm(recip[k]))) for k in range(3)]
    shifts = torch.cartesian_prod(*[torch.arange(-m, m + 1, dtype=pos.dtype) for m in reach])
    diff = pos[None, :, None, :] + (shifts @ lattice)[None, None] - pos[:, None, None, :]
    d2 = (diff * diff).sum(-1)
    i, j, s = torch.nonzero((d2 <= cutoff * cutoff) & (d2 > 1e-16), as_tuple=True)
    return i, j, shifts[s]


def angles(src, dist, cutoff):
    """(e1, e2): every ordered pair of distinct edges with one source, both
    no longer than ``cutoff``, by a loop over the sources."""
    e1, e2 = [], []
    short = torch.nonzero(dist <= cutoff, as_tuple=True)[0]
    for i in torch.unique(src[short]).tolist():
        mine = short[src[short] == i]
        for a in mine.tolist():
            for b in mine.tolist():
                if a != b:
                    e1.append(a)
                    e2.append(b)
    return torch.tensor(e1, dtype=torch.long), torch.tensor(e2, dtype=torch.long)


def bonds(src, dst, shift):
    """(E,) bond id of each directed edge: i->j at S and j->i at -S share
    one, numbered by ``torch.unique`` of a canonical key."""
    s = torch.round(shift).long()
    fwd = torch.stack([src, dst, s[:, 0], s[:, 1], s[:, 2]], 1)
    rev = torch.stack([dst, src, -s[:, 0], -s[:, 1], -s[:, 2]], 1)
    first = [fwd[k].tolist() <= rev[k].tolist() for k in range(len(src))]
    key = torch.where(torch.tensor(first)[:, None], fwd, rev)
    _, bond = torch.unique(key, dim=0, return_inverse=True)
    return bond


def rbf(w, name, r, cutoff):
    f = w[f"{name}.frequencies"]
    u = r / cutoff
    p = ENVELOPE_P
    env = (1 - (p + 1) * (p + 2) / 2 * u**p + p * (p + 2) * u ** (p + 1)
           - p * (p + 1) / 2 * u ** (p + 2))
    env = torch.where(u < 1, env, torch.zeros_like(env))
    return math.sqrt(2 / cutoff) * torch.sin(f[None] * r[:, None] / cutoff) / r[:, None] * env[:, None]


def fourier(theta, order):
    k = torch.arange(1, order + 1, dtype=theta.dtype)
    kt = theta[:, None] * k[None]
    const = torch.full((theta.shape[0], 1), 1 / math.sqrt(2), dtype=theta.dtype)
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
    """(energy per graph (B,), magnetic moment per atom (N,)) of
    concatenated structures: edges i->j with vectors ``r_vec`` (E, 3),
    their bond ids, angles (e1, e2)."""
    w = {k.removeprefix("model."): v for k, v in w.items()}
    num_bonds = int(bond.max()) + 1
    # one representative directed edge per bond: its length
    rep = torch.zeros(num_bonds, dtype=torch.long).index_put_(
        (bond,), torch.arange(len(bond)))
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
    b1, b2 = bond[e1], bond[e2]
    centre = src[e1]
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
        if t == convs - 2:
            continue
        a = a + phi(w, f"angle_update_{t}.phi", torch.cat([e[b1], e[b2], a, v[centre]], 1))
    h = v
    depth = sum(1 for k in w if k.startswith("readout.") and k.endswith(".kernel"))
    for i in range(depth):
        h = linear(w, f"readout.{i}", h)
        if i < depth - 1:
            h = F.silu(h)
    per_atom = h[:, 0] + elemental[types]
    energy = torch.zeros(num_graphs, dtype=per_atom.dtype).index_add(0, node_graph, per_atom)
    return energy, magmom


def efs(weights, cfg, structures, elemental, create_graph=False):
    """[(energy, forces (n, 3), stress (6,) Voigt [xx, yy, zz, yz, zx, xy],
    magnetic moments (n,))] of ``structures`` ((lattice, positions, atomic
    numbers) each), computed as one concatenated graph in the weights'
    dtype."""
    dtype = next(iter(weights.values())).dtype
    eye = torch.eye(3, dtype=dtype)
    pos_l, strain_l, parts = [], [], []
    off = 0
    for b, (lattice, pos, numbers) in enumerate(structures):
        lattice = torch.as_tensor(lattice, dtype=dtype)
        pos = torch.as_tensor(pos, dtype=dtype).clone().requires_grad_(True)
        strain = torch.zeros(3, 3, dtype=dtype, requires_grad=True)
        src, dst, shift = neighbor_list(pos.detach(), lattice, cfg["cutoff"])
        pos_l.append(pos)
        strain_l.append(strain)
        parts.append((lattice, src, dst, shift, torch.as_tensor(numbers) - 1, off, b))
        off += pos.shape[0]
    src = torch.cat([p[1] + p[5] for p in parts])
    dst = torch.cat([p[2] + p[5] for p in parts])
    shift = torch.cat([p[3] for p in parts])
    graph_e = torch.cat([torch.full_like(p[1], p[6]) for p in parts])
    pos_d = torch.cat([p @ (eye + s) for p, s in zip(pos_l, strain_l)])
    lat_d = torch.stack([p[0] @ (eye + s) for p, s in zip(parts, strain_l)])
    r_vec = pos_d[dst] + torch.einsum("ek,ekl->el", shift, lat_d[graph_e]) - pos_d[src]
    e1, e2 = angles(src, torch.linalg.vector_norm(r_vec, dim=1).detach(), cfg["threebody_cutoff"])
    types = torch.cat([p[4] for p in parts])
    node_graph = torch.cat([torch.full((len(p[4]),), p[6], dtype=torch.long) for p in parts])
    energy, magmom = forward(weights, cfg, types, node_graph, len(structures), src, dst,
                             bonds(src, dst, shift), r_vec, e1, e2,
                             torch.as_tensor(elemental, dtype=dtype))
    grads = torch.autograd.grad(energy.sum(), pos_l + strain_l, create_graph=create_graph)
    out = []
    for b, (lattice, *_rest) in enumerate(parts):
        vol = torch.abs(torch.linalg.det(lattice))
        g = grads[len(parts) + b]
        s = 0.5 * (g + g.T) / vol
        n0 = parts[b][5]
        n = pos_l[b].shape[0]
        out.append((energy[b], -grads[b],
                    torch.stack([s[0, 0], s[1, 1], s[2, 2], s[1, 2], s[2, 0], s[0, 1]]),
                    magmom[n0:n0 + n]))
    return out

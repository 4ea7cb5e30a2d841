"""Plain M3GNet energy model in PyTorch: the benchmark's reference.

Written from the published equations (Chen & Ong, Nat. Comput. Sci. 2, 718
(2022), arXiv:2202.02450) in the form the configuration states: the smooth
two-sinc radial basis with its Gram-Schmidt recursion, spherical Bessel
functions at their roots with the textbook normalisation, Legendre
polynomials of the bond angle, the polynomial cutoff, gated MLPs, and a
three-body sum taken triplet by triplet. No kernels, no padding, no
feature-major layout: row-major tensors, ``index_add`` sums, and autograd
for forces, stress and (with ``create_graph``) the weights' gradients of a
loss on them. It imports nothing of the program.

Weights come as the benchmark's dict (``portbench.weights``) under the
names the benchmark gives them; this module reads them by name.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F


def bessel_roots(l_max: int, n_max: int) -> np.ndarray:
    """(l_max, n_max) first positive roots of the spherical Bessel j_l,
    bracketed on a fine grid and refined by brentq."""
    from scipy.optimize import brentq
    from scipy.special import spherical_jn

    roots = np.zeros((l_max, n_max))
    for ell in range(l_max):
        found, x = [], 0.5
        while len(found) < n_max:
            if spherical_jn(ell, x) * spherical_jn(ell, x + 0.01) < 0:
                found.append(brentq(lambda z, ell=ell: spherical_jn(ell, z), x, x + 0.01,
                                    xtol=1e-15))
            x += 0.01
        roots[ell] = found
    return roots


def basis_constants(cfg: dict) -> dict:
    """The host constants of the bases: Bessel roots z_ln and the norms
    sqrt(2 / rc^3) / |j_{l+1}(z_ln)| (rc the two-body cutoff)."""
    from scipy.special import spherical_jn

    l_max, n_max, rc = cfg["l_max"], cfg["n_max"], cfg["cutoff"]
    roots = bessel_roots(l_max, n_max)
    norms = np.stack([math.sqrt(2.0 / rc**3) / np.abs(spherical_jn(ell + 1, roots[ell]))
                      for ell in range(l_max)])
    return {"roots": roots, "norms": norms}


def radial_basis(d: torch.Tensor, n_max: int, rc: float) -> torch.Tensor:
    """(E, n_max) smooth radial basis h_m(d): f_m = c_m (sinc((m+1) pi d / rc)
    + sinc((m+2) pi d / rc)) with the normalised sinc taken of the
    pi-scaled argument, orthogonalised by h_m = (f_m + sqrt(e_m / d_{m-1})
    h_{m-1}) / sqrt(d_m)."""
    hs = []
    dm_prev = 1.0
    for m in range(n_max):
        c = ((-1.0) ** m * math.sqrt(2.0) * math.pi / rc**1.5 * (m + 1) * (m + 2)
             / math.sqrt((m + 1) ** 2 + (m + 2) ** 2))
        f = c * (torch.sinc((m + 1) * math.pi / rc * d) + torch.sinc((m + 2) * math.pi / rc * d))
        if m == 0:
            h = f
        else:
            em = m**2 * (m + 2) ** 2 / (4 * (m + 1) ** 4 + 1)
            dm = 1.0 - em / dm_prev
            h = (f + math.sqrt(em / dm_prev) * hs[-1]) / math.sqrt(dm)
            dm_prev = dm
        hs.append(h)
    return torch.stack(hs, dim=1)


def spherical_jn(ell_max: int, z: torch.Tensor) -> list[torch.Tensor]:
    """j_0 .. j_{ell_max - 1} at z > 0 by upward recurrence (the arguments
    here are >= ~1: the shortest bond over the cutoff times pi)."""
    out = [torch.sin(z) / z]
    if ell_max > 1:
        out.append(torch.sin(z) / z**2 - torch.cos(z) / z)
    for ell in range(1, ell_max - 1):
        out.append((2 * ell + 1) / z * out[ell] - out[ell - 1])
    return out


def cutoff_fn(r: torch.Tensor, rc: float) -> torch.Tensor:
    u = r / rc
    return torch.where(u <= 1.0, 1.0 - 6.0 * u**5 + 15.0 * u**4 - 10.0 * u**3,
                       torch.zeros_like(u))


def legendre(x: torch.Tensor, l_max: int) -> list[torch.Tensor]:
    out = [torch.ones_like(x), x]
    for n in range(1, l_max - 1):
        out.append(((2 * n + 1) * x * out[n] - n * out[n - 1]) / (n + 1))
    return out[:l_max]


def dense(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ w[name + ".kernel"]
    bias = w.get(name + ".bias")
    return y if bias is None else y + bias


def gated_mlp(w: dict, name: str, x: torch.Tensor, depth: int, is_output: bool = False):
    """dense stack (SiLU, the last linear for an output head) times gate
    stack (SiLU, the last sigmoid)."""
    d = g = x
    for i in range(depth):
        d = dense(w, f"{name}.dense_{i}", d)
        if not (is_output and i == depth - 1):
            d = F.silu(d)
        g = dense(w, f"{name}.gate_{i}", g)
        g = torch.sigmoid(g) if i == depth - 1 else F.silu(g)
    return d * g


def energies(w: dict, cfg: dict, consts: dict, types, node_graph, num_graphs, src, dst,
             r_vec, triplets, elemental, energy_scale):
    """Per-graph total energy (eV) of concatenated structures.

    ``r_vec`` (E, 3) are the bond vectors r_ij = x_j + shift - x_i of the
    edges (src i, dst j); ``triplets`` (e1, e2) the ordered pairs of
    distinct edges i->j, i->k that share their source and both lie within
    the three-body cutoff. Weights ``w`` by the benchmark's names
    (``model.<module>.<leaf>``), ``elemental`` (num_types,) eV.
    """
    w = {k.removeprefix("model."): v for k, v in w.items()}
    l_max, n_max = cfg["l_max"], cfg["n_max"]
    rc, rc3 = cfg["cutoff"], cfg["threebody_cutoff"]
    dtype = r_vec.dtype
    e1, e2 = triplets

    d = torch.linalg.vector_norm(r_vec, dim=1)
    ew = radial_basis(d, n_max, rc)  # (E, n)
    v = w["atom_embed.embedding"][types]  # (N, D)
    e = F.silu(ew @ w["edge_init.kernel"])  # (E, D)

    # Three-body basis per triplet: chi_ln(r_ik) c_l P_l(cos jik) fc(r_ij) fc(r_ik).
    rij, rik = d[e1], d[e2]
    cos = torch.clamp((r_vec[e1] * r_vec[e2]).sum(1) / (rij * rik), -1.0, 1.0)
    fc = cutoff_fn(rij, rc3) * cutoff_fn(rik, rc3)
    roots = torch.as_tensor(consts["roots"], dtype=dtype, device=d.device)
    norms = torch.as_tensor(consts["norms"], dtype=dtype, device=d.device)
    cols = []
    pl = legendre(cos, l_max)
    for ell in range(l_max):
        c_l = math.sqrt((2 * ell + 1) / (4 * math.pi))
        for n in range(n_max):
            j = spherical_jn(ell + 1, roots[ell, n] * rik / rc)[ell]
            cols.append(norms[ell, n] * j * c_l * pl[ell] * fc)
    basis = torch.stack(cols, dim=1)  # (T, l*n), column l * n_max + n
    node_k = dst[e2]

    for b in range(cfg["num_blocks"]):
        gate = torch.sigmoid(dense(w, f"three_gate_{b}", v))  # (N, l*n)
        msg = basis * gate[node_k]
        agg = torch.zeros(e.shape[0], basis.shape[1], dtype=dtype, device=d.device)
        agg = agg.index_add(0, e1, msg)
        e = e + gated_mlp(w, f"three_mlp_{b}", agg, 1)

        e = e + gated_mlp(w, f"conv_edge_{b}", torch.cat([v[src], v[dst], e], 1), 2) * (
            ew @ w[f"conv_edge_w_{b}.kernel"])
        node_msg = gated_mlp(w, f"conv_node_{b}", torch.cat([v[src], v[dst], e], 1), 2) * (
            ew @ w[f"conv_node_w_{b}.kernel"])
        v = v + torch.zeros_like(v).index_add(0, src, node_msg)

    atomic = gated_mlp(w, "readout", v, 3, is_output=True)[:, 0]
    per_atom = elemental[types] + energy_scale * atomic
    return torch.zeros(num_graphs, dtype=dtype, device=d.device).index_add(0, node_graph, per_atom)

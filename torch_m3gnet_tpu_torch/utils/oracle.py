"""Independent numpy/scipy f64 transcription of the M3GNet forward: the
parity oracle (own copy of ``torch_m3gnet_tpu.utils.oracle``).

It re-derives the published equations in straight numpy/scipy (scipy's
``spherical_jn``, ``np.sinc``, explicit loops, ``np.add.at`` scatters) and
shares no code with the port's model, only the spherical-Bessel zeros of
``ops/basis.py``. It reads the Flax-layout parameter tree; the port's
``state_dict`` nests into one with
:func:`torch_m3gnet_tpu_torch.models.convert.flax_from_params`. It needs no
JAX, so it also checks the card's energies where JAX is absent.
"""

from __future__ import annotations

import numpy as np


def _silu(x):
    return x / (1 + np.exp(-x))


def _sigmoid(x):
    return 1 / (1 + np.exp(-x))


def _gated_mlp(x, layers):
    """layers: list of (dense_W, dense_b, gate_W, gate_b, is_output)."""
    d = x
    g = x
    n = len(layers)
    for i, (dw, db, gw, gb, is_output) in enumerate(layers):
        d = d @ dw + (db if db is not None else 0.0)
        if not (is_output and i == n - 1):
            d = _silu(d)
        g = g @ gw + (gb if gb is not None else 0.0)
        g = _sigmoid(g) if i == n - 1 else _silu(g)
    return d * g


def reference_energy_numpy(
    p, g, cfg, elemental, energy_scale, return_intermediates: bool = False,
    chi_norm=None,
):
    """Reference-equation forward (f64 numpy/scipy).

    Args:
        p: flax-layout param dict (params["params"] subtree, numpy f64;
            ``models.convert.flax_from_params`` of a port ``state_dict``).
        g: an unpadded single GraphBatch.
        cfg: M3GNetConfig-like (l_max, n_max, embedding_dim, cutoff,
            threebody_cutoff, num_blocks).
        elemental: (num_types,) per-species reference energies, eV.
        energy_scale: energy scale, eV.
        return_intermediates: also return the per-stage node/edge features
            (keyed like the reference's blackboard stages) for per-layer
            comparison against the torch reference.

    Returns total energy, or (total, intermediates dict).
    """
    from scipy.special import spherical_jn

    from torch_m3gnet_tpu_torch.ops.basis import spherical_bessel_zeros

    lmax, nmax = cfg.l_max, cfg.n_max
    rc, rc3 = cfg.cutoff, cfg.threebody_cutoff

    pos = g.positions.astype(np.float64)
    lat = g.lattice.astype(np.float64)[0]
    src, dst = g.edge_src, g.edge_dst
    t1, t2 = g.triplet_e1, g.triplet_e2

    # geometry (invariant.py:20-59)
    rvec = pos[dst] + g.edge_cell_shift.astype(np.float64) @ lat - pos[src]
    dist = np.linalg.norm(rvec, axis=1)
    cosj = np.clip(
        np.sum(rvec[t1] * rvec[t2], axis=1) / (dist[t1] * dist[t2]), -1, 1
    )

    # smooth radial basis h_m (docs/architecture.md:69-89, torch.sinc semantics)
    m = np.arange(nmax, dtype=np.float64)
    em = (m**2) * ((m + 2) ** 2) / (4 * ((m + 1) ** 4) + 1)
    dm = np.ones(nmax)
    for i in range(1, nmax):
        dm[i] = 1 - em[i] / dm[i - 1]
    coeff = (
        ((-1.0) ** m) * np.sqrt(2) * np.pi / rc**1.5
        * (m + 1) * (m + 2) / np.sqrt((m + 1) ** 2 + (m + 2) ** 2)
    )
    fm = coeff[:, None] * (
        np.sinc((m[:, None] + 1) * np.pi / rc * dist[None, :])
        + np.sinc((m[:, None] + 2) * np.pi / rc * dist[None, :])
    )
    hm = np.empty_like(fm)
    hm[0] = fm[0]
    for i in range(1, nmax):
        hm[i] = (fm[i] + np.sqrt(em[i] / dm[i - 1]) * hm[i - 1]) / np.sqrt(dm[i])
    edge_w = hm.T  # (E, nmax)

    inter = {}
    # node embedding == one-hot @ W (featurizer.py:11-38)
    v = p["atom_embed"]["embedding"][g.atom_types]
    e = _silu(edge_w @ p["edge_init"]["kernel"])
    inter["node_features/init"] = v.copy()
    inter["edge_features/init"] = e.copy()
    inter["edge_weights"] = edge_w.copy()

    # triplet constants
    def fc(r, c):
        u = r / c
        return np.where(u <= 1, 1 - 6 * u**5 + 15 * u**4 - 10 * u**3, 0.0)

    fcprod = fc(dist[t1], rc3) * fc(dist[t2], rc3)
    sph = np.stack(
        [
            np.sqrt((2 * ell + 1) / (4 * np.pi))
            * np.polynomial.legendre.legval(cosj, np.eye(ell + 1)[ell])
            for ell in range(lmax)
        ]
    )  # (l, T)
    zeros = spherical_bessel_zeros(lmax + 1, nmax)
    # chi normalization: textbook M3GNet by default; chi_norm (l, n) overrides
    # (used to mirror the reference's literal constants — see the JAX
    # package's ops/basis.reference_literal_chi_norm and docs/reference_parity.md)
    cn = (
        np.asarray(chi_norm, dtype=np.float64)
        if chi_norm is not None
        else np.stack(
            [
                np.sqrt(2 / rc**3) / np.abs(spherical_jn(ell + 1, zeros[ell]))
                for ell in range(lmax)
            ]
        )
    )
    chi = np.stack(
        [
            spherical_jn(ell, zeros[ell][:, None] * dist[t2][None, :] / rc)
            * cn[ell][:, None]
            for ell in range(lmax)
        ]
    )  # (l, n, T)
    basis = (chi * sph[:, None, :] * fcprod[None, None, :]).reshape(lmax * nmax, -1).T

    node_k = g.edge_dst[t2]
    E = len(src)
    N = len(pos)

    for b in range(cfg.num_blocks):
        # ThreeBodyInteration (interaction.py:138-223)
        gate = _sigmoid(
            v @ p[f"three_gate_{b}"]["kernel"] + p[f"three_gate_{b}"]["bias"]
        )
        msg = basis * gate[node_k]  # (T, l*n)
        agg = np.zeros((E, lmax * nmax))
        np.add.at(agg, t1, msg)
        q = p[f"three_mlp_{b}"]
        e = e + _gated_mlp(
            agg, [(q["dense_0"]["kernel"], None, q["gate_0"]["kernel"], None, False)]
        )
        inter[f"edge_features/three_{b}"] = e.copy()

        # M3GNetConv (conv.py:12-97)
        concat = np.concatenate([v[src], v[dst], e], axis=1)
        q = p[f"conv_edge_{b}"]
        upd = _gated_mlp(
            concat,
            [
                (q["dense_0"]["kernel"], q["dense_0"]["bias"],
                 q["gate_0"]["kernel"], q["gate_0"]["bias"], False),
                (q["dense_1"]["kernel"], q["dense_1"]["bias"],
                 q["gate_1"]["kernel"], q["gate_1"]["bias"], False),
            ],
        )
        e = e + upd * (edge_w @ p[f"conv_edge_w_{b}"]["kernel"])
        inter[f"edge_features/conv_{b}"] = e.copy()

        concat = np.concatenate([v[src], v[dst], e], axis=1)
        q = p[f"conv_node_{b}"]
        nupd = _gated_mlp(
            concat,
            [
                (q["dense_0"]["kernel"], q["dense_0"]["bias"],
                 q["gate_0"]["kernel"], q["gate_0"]["bias"], False),
                (q["dense_1"]["kernel"], q["dense_1"]["bias"],
                 q["gate_1"]["kernel"], q["gate_1"]["bias"], False),
            ],
        ) * (edge_w @ p[f"conv_node_w_{b}"]["kernel"])
        acc = np.zeros((N, cfg.embedding_dim))
        np.add.at(acc, src, nupd)
        v = v + acc
        inter[f"node_features/conv_{b}"] = v.copy()

    # AtomWiseReadout (readout.py:12-58)
    q = p["readout"]
    atomic = _gated_mlp(
        v,
        [
            (q["dense_0"]["kernel"], q["dense_0"]["bias"],
             q["gate_0"]["kernel"], q["gate_0"]["bias"], True),
            (q["dense_1"]["kernel"], q["dense_1"]["bias"],
             q["gate_1"]["kernel"], q["gate_1"]["bias"], True),
            (q["dense_2"]["kernel"], q["dense_2"]["bias"],
             q["gate_2"]["kernel"], q["gate_2"]["bias"], True),
        ],
    )[:, 0]
    scaled = elemental[g.atom_types] / energy_scale + atomic
    inter["scaled_atomic_energies"] = scaled.copy()
    total = energy_scale * scaled.sum()
    if return_intermediates:
        return total, inter
    return total

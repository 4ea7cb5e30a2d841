"""Vectorized three-body (triplet) index enumeration (host side, numpy).

Own copy of the numpy path of ``torch_m3gnet_tpu.data.triplets``. A triplet
t = (e1, e2) is an **ordered** pair of distinct edges sharing a source node
i, both within ``threebody_cutoff``: edge e1 = i->j, edge e2 = i->k. A node
of 3-body degree d has d*(d-1) triplets. The factorized model never reads
the triplets; the batch carries them for the throughput metric
(edges + triplets per second) and for the later ``gather`` mode.
"""

from __future__ import annotations

import numpy as np


def compute_threebody(
    num_nodes: int,
    edge_index: np.ndarray,
    distances: np.ndarray,
    threebody_cutoff: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Enumerate ordered same-source edge pairs within the 3-body cutoff.

    Returns:
        (triplet_edge_index, num_triplet_i, num_triplet_ij):
        triplet_edge_index (2, T) int64 — rows [e1, e2], indices into the FULL
        edge list; num_triplet_i (N,) — triplets per node (= d*(d-1));
        num_triplet_ij (E,) — triplets per edge as e1 (= d(src)-1 for
        participating edges, 0 otherwise).
    """
    edge_index = np.asarray(edge_index)
    distances = np.asarray(distances)
    num_edges = edge_index.shape[1]

    valid_ids = np.nonzero(distances <= threebody_cutoff)[0]
    vsrc = edge_index[0, valid_ids]

    # Explicit grouping: stable-sort participating edges by source node.
    order = np.argsort(vsrc, kind="stable")
    valid_ids = valid_ids[order]
    vsrc = vsrc[order]

    deg = np.bincount(vsrc, minlength=num_nodes).astype(np.int64)
    num_triplet_i = deg * (deg - 1)
    total = int(num_triplet_i.sum())

    num_triplet_ij = np.zeros(num_edges, dtype=np.int64)
    num_triplet_ij[valid_ids] = deg[vsrc] - 1

    if total == 0:
        return np.zeros((2, 0), dtype=np.int64), num_triplet_i, num_triplet_ij

    # Local pair p in [0, d*(d-1)) of a node of degree d maps to
    # (j, k) = (p // (d-1), q + (q >= j)) with q = p % (d-1): k runs over all
    # slots except j.
    node_of_t = np.repeat(np.arange(num_nodes), num_triplet_i)  # (T,)
    t_starts = np.cumsum(num_triplet_i) - num_triplet_i  # (N,)
    p = np.arange(total) - t_starts[node_of_t]
    d_t = deg[node_of_t]
    j = p // (d_t - 1)
    q = p % (d_t - 1)
    k = q + (q >= j)

    e_starts = np.cumsum(deg) - deg  # first participating-edge slot per node
    base = e_starts[node_of_t]
    e1 = valid_ids[base + j]
    e2 = valid_ids[base + k]

    return np.stack([e1, e2]).astype(np.int64), num_triplet_i, num_triplet_ij

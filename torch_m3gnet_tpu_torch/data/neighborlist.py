"""PBC neighbor list (host side, vectorized numpy).

Own copy of the numpy path of ``torch_m3gnet_tpu.data.neighborlist``: a full
(directed, both i->j and j->i) neighbor list with integer periodic-image
shifts, sorted by source node. The C++ cell-list path of the JAX package is
not ported yet; this path is O(N^2 * images) and serves cells of a few
hundred atoms.
"""

from __future__ import annotations

import numpy as np


def _image_bounds(lattice: np.ndarray, cutoff: float) -> np.ndarray:
    """Number of periodic images needed per lattice direction.

    ``h_i = 1 / |row_i(inv(A)^T)|`` is the spacing between lattice planes
    orthogonal to reciprocal vector ``b_i``; any neighbor within ``cutoff`` of
    an atom in the home cell lies within ``ceil(cutoff / h_i)`` images (+1 for
    atoms sitting anywhere inside the cell).
    """
    recip = np.linalg.inv(lattice).T
    h = 1.0 / np.linalg.norm(recip, axis=1)
    return np.ceil(cutoff / h).astype(np.int64) + 1


def neighbor_list_pbc(
    lattice: np.ndarray,
    cart_coords: np.ndarray,
    cutoff: float,
    chunk_size: int = 4_000_000,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full directed neighbor list under periodic boundary conditions.

    Args:
        lattice: (3, 3) row-wise lattice matrix.
        cart_coords: (N, 3) cartesian positions (need not be wrapped).
        cutoff: inclusive distance cutoff.
        chunk_size: max number of candidate pairs per vectorized block.

    Returns:
        (edge_index, edge_cell_shift, distances):
        edge_index (2, E) int64 rows [src, dst], sorted by (src, dst, shift);
        edge_cell_shift (E, 3) int64 with r_ij = pos[dst] + shift @ lattice - pos[src];
        distances (E,) float64.
    """
    lattice = np.asarray(lattice, dtype=np.float64)
    pos = np.asarray(cart_coords, dtype=np.float64)
    n = pos.shape[0]
    if n == 0:
        return (
            np.zeros((2, 0), dtype=np.int64),
            np.zeros((0, 3), dtype=np.int64),
            np.zeros((0,), dtype=np.float64),
        )

    nmax = _image_bounds(lattice, cutoff)
    ranges = [np.arange(-m, m + 1) for m in nmax]
    shifts = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
    shift_cart = shifts @ lattice  # (S, 3)
    s = shifts.shape[0]

    srcs, dsts, shs, dists = [], [], [], []
    # Chunk over source atoms to bound peak memory at ~chunk_size pairs.
    rows_per_chunk = max(1, chunk_size // (n * s))
    for i0 in range(0, n, rows_per_chunk):
        i1 = min(n, i0 + rows_per_chunk)
        # diff[a, j, t] = pos[j] + shift[t] - pos[i0+a]
        diff = (
            pos[None, :, None, :] + shift_cart[None, None, :, :] - pos[i0:i1, None, None, :]
        )  # (A, N, S, 3)
        d = np.sqrt(np.sum(diff * diff, axis=-1))  # (A, N, S)
        mask = d <= cutoff
        mask &= d > 1e-8  # drop self-pairs in the home cell (distance 0)
        a_idx, j_idx, t_idx = np.nonzero(mask)
        srcs.append(a_idx + i0)
        dsts.append(j_idx)
        shs.append(shifts[t_idx])
        dists.append(d[a_idx, j_idx, t_idx])

    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    sh = np.concatenate(shs)
    dist = np.concatenate(dists)

    order = np.lexsort((sh[:, 2], sh[:, 1], sh[:, 0], dst, src))
    edge_index = np.stack([src[order], dst[order]])
    return edge_index, sh[order].astype(np.int64), dist[order]

"""Plain periodic neighbour search and triplet enumeration for the reference.

Every pair (i, j, image shift S) with |x_j + S L - x_i| <= cutoff, found by
brute force over the images that can reach the cutoff, in blocks of source
rows so that a large cell fits. Triplets are the ordered pairs of distinct
edges that share their source, both within the three-body cutoff.
"""

from __future__ import annotations

import math

import torch


def image_bounds(lattice: torch.Tensor, cutoff: float) -> list[int]:
    """Images needed along each lattice vector: ceil(cutoff / plane spacing),
    the spacing of the planes of a_k being 1 / |b_k| (b the reciprocal rows)."""
    recip = torch.linalg.inv(lattice).T  # rows b_k with a_i . b_k = delta_ik
    return [math.ceil(cutoff * float(torch.linalg.vector_norm(recip[k]))) for k in range(3)]


def neighbor_list(pos: torch.Tensor, lattice: torch.Tensor, cutoff: float,
                  block_pairs: int = 1 << 25):
    """(src, dst, shift) of one structure: int64 (E,), (E,), float (E, 3)
    integer-valued shifts, with src ascending. ``pos`` (n, 3) and
    ``lattice`` (3, 3) rows, in float64."""
    n = pos.shape[0]
    nb = image_bounds(lattice, cutoff)
    ranges = [torch.arange(-m, m + 1, device=pos.device, dtype=pos.dtype) for m in nb]
    shifts = torch.cartesian_prod(*ranges)  # (S, 3)
    shift_cart = shifts @ lattice
    rows = max(1, block_pairs // max(1, n * shifts.shape[0]))
    out = []
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        diff = pos[None, :, None, :] + shift_cart[None, None] - pos[i0:i1, None, None, :]
        d2 = (diff * diff).sum(-1)  # (rows, n, S)
        keep = (d2 <= cutoff * cutoff) & (d2 > 1e-16)
        a, j, s = torch.nonzero(keep, as_tuple=True)
        out.append((a + i0, j, shifts[s]))
    src = torch.cat([o[0] for o in out])
    dst = torch.cat([o[1] for o in out])
    shift = torch.cat([o[2] for o in out])
    return src, dst, shift


def triplets(src: torch.Tensor, dist: torch.Tensor, num_nodes: int, threebody_cutoff: float):
    """(e1, e2): every ordered pair of distinct edges with the same source,
    both of length <= ``threebody_cutoff``; ``src`` ascending."""
    ids = torch.nonzero(dist <= threebody_cutoff, as_tuple=True)[0]
    s = src[ids]
    deg = torch.bincount(s, minlength=num_nodes)
    start = torch.cumsum(deg, 0) - deg
    # For each participating edge a, pair it with every other edge of its source.
    d_a = deg[s]
    pairs = d_a * (d_a - 1) // torch.clamp(d_a, min=1)  # d - 1 partners each
    e1_slot = torch.repeat_interleave(torch.arange(ids.numel(), device=src.device), pairs)
    first = torch.cumsum(pairs, 0) - pairs
    q = torch.arange(e1_slot.numel(), device=src.device) - first[e1_slot]
    own = e1_slot - start[s[e1_slot]]  # slot of e1 within its source's run
    partner = q + (q >= own).long()
    e2_slot = start[s[e1_slot]] + partner
    return ids[e1_slot], ids[e2_slot]

"""Debug and diagnostic modes (counterpart of ``torch_m3gnet_tpu.utils.debug``).

- :func:`enable_nan_checks`: torch's anomaly mode;
- :func:`check_batch`: host-side structural validation of a
  :class:`~torch_m3gnet_tpu_torch.data.GraphBatch` (index bounds, mask
  consistency, sortedness) before it reaches the model.
"""

from __future__ import annotations

import numpy as np


def enable_nan_checks(on: bool = True) -> None:
    """Turn torch's anomaly mode on (or off) for the whole process.

    It is not JAX's ``jax_debug_nans``, which stops at the first operation
    that makes a NaN, forward or backward. ``torch.autograd.set_detect_anomaly``
    checks the backward pass: a backward function that returns NaN raises,
    with the traceback of the forward operation that made it. A NaN made in
    a forward pass run without autograd (evaluation under ``no_grad``, the
    MD and relaxation loops) goes unreported; check those outputs with
    ``torch.isfinite``. Anomaly mode slows every backward pass.
    """
    import torch

    torch.autograd.set_detect_anomaly(on)


def check_batch(batch) -> list[str]:
    """Validate structural invariants; returns a list of violations (empty = ok).

    The fields are read through ``np.asarray``: a host batch, or one whose
    tensors are on the CPU.
    """
    errs: list[str] = []
    n, e, b = batch.num_nodes, batch.num_edges, batch.num_graphs
    src = np.asarray(batch.edge_src)
    dst = np.asarray(batch.edge_dst)
    t1 = np.asarray(batch.triplet_e1)
    t2 = np.asarray(batch.triplet_e2)
    ng = np.asarray(batch.node_graph)
    em = np.asarray(batch.edge_mask, dtype=bool)
    tm = np.asarray(batch.triplet_mask, dtype=bool)

    if not ((src >= 0).all() and (src < n).all()):
        errs.append("edge_src out of node range")
    if not ((dst >= 0).all() and (dst < n).all()):
        errs.append("edge_dst out of node range")
    if not ((t1 >= 0).all() and (t1 < e).all() and (t2 >= 0).all() and (t2 < e).all()):
        errs.append("triplet edge ids out of edge range")
    if not ((ng >= 0).all() and (ng < b).all()):
        errs.append("node_graph out of graph range")
    if em.any() and (np.diff(src[em]) < 0).any():
        errs.append("real edges not sorted by source")
    if tm.any():
        s1 = src[t1[tm]]
        s2 = src[t2[tm]]
        if (s1 != s2).any():
            errs.append("triplet edges do not share a source node")
        if (t1[tm] == t2[tm]).any():
            errs.append("degenerate triplet (e1 == e2)")
    if batch.forces is not None and np.asarray(batch.forces).shape[0] != n:
        errs.append("forces length != num_nodes")
    return errs

"""Padded batch streams for training: one worst-case bucket, shuffled
batches, a random split.

Own copies of ``BucketSpec.for_batches``, ``batch_iterator`` and
``split_dataset`` of ``torch_m3gnet_tpu.data.dataset``. Every batch of one
bucket has the same padded shapes; the port runs eagerly and needs no
static shapes, but the same padding keeps the batches, their masks and so
the losses identical to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from torch_m3gnet_tpu_torch.data.graph import GraphBatch, batch_graphs, pad_batch, round_up


@dataclass(frozen=True)
class BucketSpec:
    """Padded sizes of one batch shape."""

    max_nodes: int
    max_edges: int
    max_triplets: int
    max_graphs: int

    @classmethod
    def for_batches(
        cls,
        graphs: Sequence[GraphBatch],
        batch_size: int,
        pad_multiple: int = 128,
        safety: float = 1.0,
    ) -> "BucketSpec":
        """Worst-case bucket: the sum of the ``batch_size`` largest graphs,
        so any shuffled batch fits."""
        k = min(batch_size, len(graphs))
        nodes = sorted((g.num_nodes for g in graphs), reverse=True)[:k]
        edges = sorted((g.num_edges for g in graphs), reverse=True)[:k]
        trips = sorted((g.num_triplets for g in graphs), reverse=True)[:k]
        return cls(
            max_nodes=round_up(int(sum(nodes) * safety) + 1, pad_multiple),
            max_edges=round_up(int(sum(edges) * safety) + 1, pad_multiple),
            max_triplets=round_up(int(sum(trips) * safety) + 1, pad_multiple),
            max_graphs=batch_size,
        )


def batch_iterator(
    graphs: Sequence[GraphBatch],
    batch_size: int,
    bucket: BucketSpec,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = False,
) -> Iterator[GraphBatch]:
    """Yield shuffled (when ``rng`` is given) padded host batches; the final
    short batch is padded with empty graphs up to ``max_graphs``."""
    order = np.arange(len(graphs))
    if rng is not None:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        if len(idx) < batch_size and drop_last:
            return
        cat = batch_graphs([graphs[i] for i in idx])
        yield pad_batch(
            cat, bucket.max_nodes, bucket.max_edges, bucket.max_triplets, bucket.max_graphs
        )


def split_dataset(
    n: int, val_ratio: float, test_ratio: float, seed: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random index split (train, val, test)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_val = int(n * val_ratio)
    n_test = int(n * test_ratio)
    return order[n_val + n_test :], order[:n_val], order[n_val : n_val + n_test]

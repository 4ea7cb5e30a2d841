"""Graph datasets and padded batch streams for training: a cached
in-memory dataset, one worst-case bucket or a ladder of size-class
buckets, shuffled batches, a random split.

Own copies of ``GraphDataset``, ``BucketSpec``, ``batch_iterator``,
``BucketLadder``, ``ladder_batch_iterator`` and ``split_dataset`` of
``torch_m3gnet_tpu.data.dataset``. Every batch of one bucket has the same
padded shapes; the port runs eagerly and needs no static shapes, but the
same padding keeps the batches, their masks and so the losses identical to
the JAX package's.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from torch_m3gnet_tpu_torch.data.graph import (
    GraphBatch,
    batch_graphs,
    graph_from_structure,
    pad_batch,
    round_up,
)
from torch_m3gnet_tpu_torch.data.structure import Structure


def _build_one(args) -> GraphBatch:
    structure, cutoff, threebody_cutoff = args
    return graph_from_structure(structure, cutoff, threebody_cutoff)


def build_graphs(structures, cutoff: float, threebody_cutoff: float, num_workers: int = 0,
                 chunksize: int = 16) -> Iterator[GraphBatch]:
    """The unpadded graph of each structure, in order; with ``num_workers >
    1`` built in a pool of spawned processes (a fork of a process that has
    threads or a CUDA context is not safe; the workers touch no device)."""
    jobs = ((s, cutoff, threebody_cutoff) for s in structures)
    if num_workers <= 1:
        yield from map(_build_one, jobs)
        return
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx) as pool:
        yield from pool.map(_build_one, jobs, chunksize=chunksize)


# (field, per-graph count axis) of the concatenated shard arrays.
_CONCAT_FIELDS = (
    ("positions", "n"),
    ("atom_types", "n"),
    ("edge_src", "e"),
    ("edge_dst", "e"),
    ("edge_cell_shift", "e"),
    ("triplet_e1", "t"),
    ("triplet_e2", "t"),
    ("triplet_node_k", "t"),
    ("forces", "n"),
)


def pack_graphs(graphs: Sequence[GraphBatch]) -> dict:
    """Concatenate unpadded graphs into one flat array dict (a shard, or a cache)."""
    out: dict = {
        "n_node": np.array([g.num_nodes for g in graphs], np.int64),
        "n_edge": np.array([g.num_edges for g in graphs], np.int64),
        "n_triplet": np.array([g.num_triplets for g in graphs], np.int64),
    }
    if not graphs:  # an empty split (e.g. no validation set) packs to counts only
        return {**out, "lattice": np.zeros((0, 3, 3))}
    out["lattice"] = np.concatenate([np.asarray(g.lattice) for g in graphs])
    for field, _ in _CONCAT_FIELDS:
        vals = [getattr(g, field) for g in graphs]
        if any(v is None for v in vals):
            continue
        out[field] = np.concatenate([np.asarray(v) for v in vals])
    for field in ("energy", "stress"):
        if all(getattr(g, field) is not None for g in graphs):
            out[field] = np.concatenate([np.asarray(getattr(g, field)) for g in graphs])
    return out


def unpack_graphs(z) -> list[GraphBatch]:
    """The unpadded graphs of a :func:`pack_graphs` dict (or its npz), as
    slices of the flat arrays."""
    n_node, n_edge, n_trip = z["n_node"], z["n_edge"], z["n_triplet"]
    starts = {
        axis: np.concatenate([[0], np.cumsum(counts)])
        for axis, counts in (("n", n_node), ("e", n_edge), ("t", n_trip))
    }
    arrays = {f: z[f] if f in z else None for f, _ in _CONCAT_FIELDS}
    lattice = z["lattice"]
    energy = z["energy"] if "energy" in z else None
    stress = z["stress"] if "stress" in z else None

    graphs = []
    for i in range(len(n_node)):
        def take(field, axis):
            a = arrays[field]
            return None if a is None else a[starts[axis][i] : starts[axis][i + 1]]

        n = int(n_node[i])
        graphs.append(
            GraphBatch(
                positions=take("positions", "n"),
                atom_types=take("atom_types", "n"),
                node_graph=np.zeros(n, np.int32),
                node_mask=np.ones(n, bool),
                edge_src=take("edge_src", "e"),
                edge_dst=take("edge_dst", "e"),
                edge_cell_shift=take("edge_cell_shift", "e"),
                edge_mask=np.ones(int(n_edge[i]), bool),
                triplet_e1=take("triplet_e1", "t"),
                triplet_e2=take("triplet_e2", "t"),
                triplet_mask=np.ones(int(n_trip[i]), bool),
                triplet_node_k=take("triplet_node_k", "t"),
                lattice=lattice[i : i + 1],
                graph_mask=np.ones(1, bool),
                n_node=np.array([n], np.int32),
                energy=None if energy is None else energy[i : i + 1],
                forces=take("forces", "n"),
                stress=None if stress is None else stress[i : i + 1],
                num_graphs_real=1,
            )
        )
    return graphs


class GraphDataset:
    """An in-memory list of unpadded graphs with a disk cache.

    The cache is ``torch_graphs_{name}_{key}.npz`` in ``cache_dir``, keyed
    as the JAX package keys its ``graphs_{name}_{key}.pkl`` (name, count,
    cutoffs): plain arrays in the streaming shard format
    (:func:`pack_graphs`), with no pickle, under a name that the JAX cache
    never takes, so neither package opens the other's file.
    """

    def __init__(
        self,
        structures: Sequence[Structure],
        cutoff: float,
        threebody_cutoff: float,
        cache_dir: Optional[str] = None,
        num_workers: int = 0,
        name: str = "dataset",
    ):
        self.cutoff = cutoff
        self.threebody_cutoff = threebody_cutoff
        key = hashlib.sha1(
            f"{name}:{len(structures)}:{cutoff}:{threebody_cutoff}".encode()
        ).hexdigest()[:8]
        self.cache_path = (
            os.path.join(cache_dir, f"torch_graphs_{name}_{key}.npz") if cache_dir else None
        )
        if self.cache_path and os.path.exists(self.cache_path):
            with np.load(self.cache_path) as z:
                self.graphs: list[GraphBatch] = unpack_graphs(z)
            return
        self.graphs = list(build_graphs(structures, cutoff, threebody_cutoff, num_workers))
        if self.cache_path:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{self.cache_path}.{os.getpid()}.tmp.npz"
            np.savez_compressed(tmp, **pack_graphs(self.graphs))
            os.replace(tmp, self.cache_path)

    def __len__(self) -> int:
        return len(self.graphs)

    def __getitem__(self, i: int) -> GraphBatch:
        return self.graphs[i]


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


@dataclass(frozen=True)
class BucketLadder:
    """Size-class buckets for datasets whose structure sizes spread widely
    (MPF): graphs fall into classes by triplet count (the dominant axis),
    and each class's batches pad to that class's own worst-case bucket."""

    buckets: tuple  # tuple[BucketSpec, ...], small to large
    assignments: np.ndarray  # (num_graphs,) class of each graph

    @classmethod
    def build(
        cls,
        graphs: Sequence[GraphBatch],
        batch_size: int,
        num_classes: int = 3,
        pad_multiple: int = 128,
    ) -> "BucketLadder":
        order = np.argsort(np.array([g.num_triplets for g in graphs]))
        assignments = np.zeros(len(graphs), dtype=np.int64)
        buckets = []
        for idx in np.array_split(order, num_classes):
            if len(idx) == 0:
                continue
            assignments[idx] = len(buckets)
            buckets.append(
                BucketSpec.for_batches([graphs[i] for i in idx], batch_size, pad_multiple)
            )
        return cls(buckets=tuple(buckets), assignments=assignments)

    def padding_efficiency(self, graphs: Sequence[GraphBatch], batch_size: int) -> float:
        """Real triplets over padded triplet slots in one epoch (at most 1)."""
        total_real = sum(g.num_triplets for g in graphs)
        total_slots = 0
        for ci, b in enumerate(self.buckets):
            n = int((self.assignments == ci).sum())
            total_slots += -(-n // batch_size) * b.max_triplets
        return total_real / max(total_slots, 1)


def ladder_batch_iterator(
    graphs: Sequence[GraphBatch],
    batch_size: int,
    ladder: BucketLadder,
    rng: Optional[np.random.Generator] = None,
) -> Iterator[GraphBatch]:
    """Batches drawn within each size class in turn (shuffled when ``rng``
    is given), each padded to its class's bucket."""
    for ci, bucket in enumerate(ladder.buckets):
        idx = np.nonzero(ladder.assignments == ci)[0]
        if rng is not None:
            rng.shuffle(idx)
        for start in range(0, len(idx), batch_size):
            cat = batch_graphs([graphs[i] for i in idx[start : start + batch_size]])
            yield pad_batch(
                cat, bucket.max_nodes, bucket.max_edges, bucket.max_triplets, bucket.max_graphs
            )


def sharded_batch_iterator(
    graphs: Sequence[GraphBatch],
    per_device_batch: int,
    n_devices: int,
    bucket: BucketSpec,
    rng: Optional[np.random.Generator] = None,
    rank: Optional[int] = None,
) -> Iterator[GraphBatch]:
    """Global batches of ``per_device_batch * n_devices`` graphs for the
    data-parallel step (``parallel.dp``), shuffled when ``rng`` is given;
    each is :func:`stack_global_batch` of its graphs (with ``rank``, only
    that rank's row)."""
    order = np.arange(len(graphs))
    if rng is not None:
        rng.shuffle(order)
    global_bs = per_device_batch * n_devices
    for start in range(0, len(order), global_bs):
        idx = order[start : start + global_bs]
        yield stack_global_batch([graphs[i] for i in idx], per_device_batch, n_devices, bucket,
                                 rank=rank)


def stack_global_batch(
    graphs: Sequence[GraphBatch],
    per_device_batch: int,
    n_devices: int,
    bucket: BucketSpec,
    rank: Optional[int] = None,
) -> GraphBatch:
    """A (possibly short) global batch in the dp layout: ``graphs`` split
    into ``n_devices`` contiguous rows of ``per_device_batch``, each padded
    to ``bucket``, stacked along a new leading axis; every row carries the
    global batch's count of real graphs. A row past the end of a short list
    is fully padded, every mask zero, so the dp step's weights ignore it.
    With ``rank``, only that row (row ``rank`` of the stack), built alone.
    """
    from torch_m3gnet_tpu_torch.parallel.dp import shard_stack

    def row(d):
        sel = graphs[d * per_device_batch : (d + 1) * per_device_batch]
        padded = pad_batch(batch_graphs(list(sel) if sel else [graphs[0]]), bucket.max_nodes,
                           bucket.max_edges, bucket.max_triplets, bucket.max_graphs)
        if not sel:
            padded = padded.replace(
                node_mask=np.zeros_like(padded.node_mask),
                edge_mask=np.zeros_like(padded.edge_mask),
                triplet_mask=np.zeros_like(padded.triplet_mask),
                graph_mask=np.zeros_like(padded.graph_mask),
                num_graphs_real=0,
            )
        return padded

    if rank is None:
        return shard_stack([row(d) for d in range(n_devices)])
    return row(rank).replace(num_graphs_real=sum(g.num_graphs_real for g in graphs))


def split_dataset(
    n: int, val_ratio: float, test_ratio: float, seed: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random index split (train, val, test)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_val = int(n * val_ratio)
    n_test = int(n * test_ratio)
    return order[n_val + n_test :], order[:n_val], order[n_val : n_val + n_test]

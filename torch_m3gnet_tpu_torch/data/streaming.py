"""Streaming graph dataset: a sharded npz cache and bounded-memory iteration.

Own copy of ``torch_m3gnet_tpu.data.streaming``, for datasets too large
to hold as one list (MPF.2021.2.8, ~187k structures):

- **Build**: structures become graphs (``data.dataset.build_graphs``, a
  spawned process pool when ``num_workers > 1``) and are written in shards
  of ``shard_size`` graphs, each ONE ``savez_compressed`` npz of the
  concatenated arrays and per-graph counts (``data.dataset.pack_graphs``).
  ``index.npz`` holds per-graph sizes, energies and species counts,
  ``meta.json`` the shard count and cutoffs. The format, the cache key and the directory name are the JAX
  package's, and the files are plain arrays (no pickle), so a cache
  written by either package opens in the other.
- **Iterate**: ``iter_graphs`` and ``stream_batches`` decode shards in a
  background thread, a few ahead; memory is O(shard_size) graphs. Shuffling
  is two-level (shard order, then order within the shard). An abandoned
  iterator stops its thread: every queue put retries against a stop flag.
- **Fit**: ``fit_elemental_energies_streaming`` solves the least squares of
  ``train.elemental`` from the index alone (normal equations, pinv).
- **Bucketing**: ``ladder_from_index`` and ``stream_ladder_batches`` give
  ``BucketLadder``'s per-class padding without reading a shard.
- **Data parallelism**: ``stream_sharded_batches`` and
  ``stream_ladder_sharded_batches`` give the dp layout
  (``data.dataset.stack_global_batch``), each rank only its own row
  (every rank reads every shard); ``HostShardView`` is one host's stride
  of the shards.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from torch_m3gnet_tpu_torch.data.dataset import (
    BucketLadder,
    BucketSpec,
    build_graphs,
    pack_graphs,
    stack_global_batch,
    unpack_graphs,
)
from torch_m3gnet_tpu_torch.data.graph import GraphBatch, batch_graphs, pad_batch, round_up
from torch_m3gnet_tpu_torch.data.structure import Structure


def background(items: Iterable, size: int) -> Iterator:
    """Iterate ``items`` in a daemon thread, up to ``size`` items ahead.

    An exception of ``items`` re-raises in the consumer. Every put,
    the end marker and the exception included, retries against a stop flag
    that the consumer sets when it finishes or is abandoned (closed or
    collected), so the thread ends and frees what it holds instead of
    blocking on a full queue forever.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in items:
                if stop.is_set() or not put(item):
                    return
        except BaseException as exc:  # re-raised by the consumer
            put(exc)
            return
        put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer between its flag checks
            try:
                q.get_nowait()
            except queue.Empty:
                break


class StreamingGraphDataset:
    """Sharded on-disk graph dataset with bounded-memory iteration."""

    def __init__(
        self,
        structures: Optional[Iterable[Structure]],
        cutoff: float,
        threebody_cutoff: float,
        cache_dir: str,
        name: str = "dataset",
        shard_size: int = 256,
        num_workers: int = 0,
        num_types: int = 95,
        expected_count: Optional[int] = None,
    ):
        """Build (or open) the shard cache.

        ``structures`` may be any iterable, a generator included (nothing is
        held beyond the current shard); ``None`` opens an existing cache or
        raises. ``expected_count`` keys the cache when ``structures`` has no
        ``len``.
        """
        self.cutoff = cutoff
        self.threebody_cutoff = threebody_cutoff
        self.num_types = num_types
        count = (
            expected_count
            if expected_count is not None
            else (len(structures) if hasattr(structures, "__len__") else "gen")
        )
        key = hashlib.sha1(
            f"{name}:{count}:{cutoff}:{threebody_cutoff}:{shard_size}".encode()
        ).hexdigest()[:8]
        self.dir = os.path.join(cache_dir, f"stream_{name}_{key}")
        self._index_path = os.path.join(self.dir, "index.npz")
        self._meta_path = os.path.join(self.dir, "meta.json")

        if not os.path.exists(self._meta_path):
            if structures is None:
                raise FileNotFoundError(f"no stream cache at {self.dir}")
            self._build(structures, shard_size, num_workers)
        self._load_index()

    def _build(self, structures, shard_size: int, num_workers: int) -> None:
        os.makedirs(self.dir, exist_ok=True)
        sizes_n, sizes_e, sizes_t, energies, species = [], [], [], [], []
        n_shards = 0
        buf: list[GraphBatch] = []
        has_forces = has_stress = True
        for g in build_graphs(structures, self.cutoff, self.threebody_cutoff, num_workers,
                              chunksize=8):
            buf.append(g)
            sizes_n.append(g.num_nodes)
            sizes_e.append(g.num_edges)
            sizes_t.append(g.num_triplets)
            energies.append(float(np.asarray(g.energy).sum()) if g.energy is not None
                            else np.nan)
            species.append(np.bincount(np.asarray(g.atom_types),
                                       minlength=self.num_types).astype(np.int32))
            has_forces &= g.forces is not None
            has_stress &= g.stress is not None
            if len(buf) == shard_size:
                self._write_shard(n_shards, buf)
                n_shards += 1
                buf = []
        if buf:
            self._write_shard(n_shards, buf)
            n_shards += 1

        np.savez_compressed(
            self._index_path,
            n_node=np.array(sizes_n, np.int64),
            n_edge=np.array(sizes_e, np.int64),
            n_triplet=np.array(sizes_t, np.int64),
            energy=np.array(energies, np.float64),
            species=np.stack(species) if species else np.zeros((0, self.num_types), np.int32),
        )
        # meta.json last: its presence marks a complete cache.
        with open(self._meta_path, "w") as f:
            json.dump(
                {
                    "n_graphs": len(sizes_n),
                    "n_shards": n_shards,
                    "shard_size": shard_size,
                    "has_forces": bool(has_forces),
                    "has_stress": bool(has_stress),
                    "cutoff": self.cutoff,
                    "threebody_cutoff": self.threebody_cutoff,
                },
                f,
            )

    def _write_shard(self, i: int, graphs: Sequence[GraphBatch]) -> None:
        np.savez_compressed(os.path.join(self.dir, f"shard_{i:05d}.npz"), **pack_graphs(graphs))

    def _load_index(self) -> None:
        with open(self._meta_path) as f:
            self.meta = json.load(f)
        with np.load(self._index_path) as z:
            self.sizes_n = z["n_node"]
            self.sizes_e = z["n_edge"]
            self.sizes_t = z["n_triplet"]
            self.energies = z["energy"]
            self.species = z["species"]
        self.n_shards = self.meta["n_shards"]
        self.shard_size = self.meta["shard_size"]

    def __len__(self) -> int:
        return int(self.meta["n_graphs"])

    def load_shard(self, i: int) -> list[GraphBatch]:
        with np.load(os.path.join(self.dir, f"shard_{i:05d}.npz")) as z:
            return unpack_graphs(z)

    def iter_graphs(
        self, rng: Optional[np.random.Generator] = None, prefetch: int = 2
    ) -> Iterator[GraphBatch]:
        """Lazily yield the unpadded graphs, shards decoded up to
        ``prefetch`` ahead in a background thread; with ``rng``, the shard
        order and each shard's graph order are shuffled (the same draws as
        the JAX package's, so one ``rng`` state gives one order in both)."""
        shard_order = np.arange(self.n_shards)
        if rng is not None:
            rng.shuffle(shard_order)
        seeds = rng.integers(0, 2**31, size=self.n_shards) if rng is not None else None

        def shards():
            for k, si in enumerate(shard_order):
                graphs = self.load_shard(int(si))
                if seeds is not None:
                    order = np.random.default_rng(int(seeds[k])).permutation(len(graphs))
                    graphs = [graphs[j] for j in order]
                yield graphs

        with contextlib.closing(background(shards(), prefetch)) as it:
            for graphs in it:
                yield from graphs

    def bucket(self, batch_size: int, pad_multiple: int = 128) -> BucketSpec:
        """The worst-case BucketSpec, from the index (no shard read)."""
        return _worst_case(self, np.arange(len(self)), batch_size, pad_multiple)


def _worst_case(ds, idx: np.ndarray, batch_size: int, pad_multiple: int) -> BucketSpec:
    """``BucketSpec.for_batches``'s rule on the index sizes of graphs ``idx``."""
    k = min(batch_size, len(idx))

    def top(a):
        return int(np.sort(a[idx])[::-1][:k].sum())

    return BucketSpec(
        max_nodes=round_up(top(ds.sizes_n) + 1, pad_multiple),
        max_edges=round_up(top(ds.sizes_e) + 1, pad_multiple),
        max_triplets=round_up(top(ds.sizes_t) + 1, pad_multiple),
        max_graphs=batch_size,
    )


def _padded(graphs: Sequence[GraphBatch], b: BucketSpec) -> GraphBatch:
    return pad_batch(batch_graphs(graphs), b.max_nodes, b.max_edges, b.max_triplets,
                     b.max_graphs)


def _groups(ds, size: int, rng: Optional[np.random.Generator]) -> Iterator[list]:
    """The streamed graphs in lists of ``size`` (the last may be short)."""
    pending: list[GraphBatch] = []
    with contextlib.closing(ds.iter_graphs(rng=rng)) as graphs:
        for g in graphs:
            pending.append(g)
            if len(pending) == size:
                yield pending
                pending = []
    if pending:
        yield pending


def stream_batches(
    ds: StreamingGraphDataset,
    batch_size: int,
    bucket: BucketSpec,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = False,
) -> Iterator[GraphBatch]:
    """Padded batches of one bucket from a streaming dataset."""
    for graphs in _groups(ds, batch_size, rng):
        if len(graphs) < batch_size and drop_last:
            return
        yield _padded(graphs, bucket)


class HostShardView:
    """One host's (one rank's) view of a streaming dataset: the shards
    ``host_id::num_hosts``.

    Every host opens the same shard cache and iterates a disjoint stride of
    shards. ``len``, the index arrays, ``bucket`` and the streaming
    elemental fit see only the viewed graphs; buckets and ladders built
    from the whole index stay valid for every host (each class bucket is a
    worst case over a superset). ``train_model`` does not use it, as JAX's
    does not: its dp ranks keep the single-process batch order.
    """

    def __init__(self, ds: StreamingGraphDataset, host_id: int, num_hosts: int):
        if not (0 <= host_id < num_hosts):
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        self.ds = ds
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.shard_ids = list(range(host_id, ds.n_shards, num_hosts))
        n = len(ds)
        starts = [s * ds.shard_size for s in self.shard_ids]
        stops = [min(st + ds.shard_size, n) for st in starts]
        sel = (np.concatenate([np.arange(a, b) for a, b in zip(starts, stops)])
               if self.shard_ids else np.zeros(0, np.int64))
        self._sel = sel
        self.sizes_n = ds.sizes_n[sel]
        self.sizes_e = ds.sizes_e[sel]
        self.sizes_t = ds.sizes_t[sel]
        self.energies = ds.energies[sel]
        self.species = ds.species[sel]
        self.meta = ds.meta
        self.shard_size = ds.shard_size
        self.n_shards = len(self.shard_ids)

    def __len__(self) -> int:
        return int(self._sel.size)

    def load_shard(self, i: int) -> list[GraphBatch]:
        return self.ds.load_shard(self.shard_ids[i])

    # the iteration and bucket machinery, by duck typing
    iter_graphs = StreamingGraphDataset.iter_graphs
    bucket = StreamingGraphDataset.bucket


def stream_sharded_batches(
    ds: StreamingGraphDataset,
    per_device_batch: int,
    n_devices: int,
    bucket: BucketSpec,
    rng: Optional[np.random.Generator] = None,
    rank: Optional[int] = None,
) -> Iterator[GraphBatch]:
    """Data-parallel batches from a streaming dataset, in bounded memory:
    every ``per_device_batch * n_devices`` streamed graphs become one
    ``data.dataset.stack_global_batch`` of one bucket (with ``rank``, that
    rank's row); a short tail leaves its last rows fully padded."""
    for graphs in _groups(ds, per_device_batch * n_devices, rng):
        yield stack_global_batch(graphs, per_device_batch, n_devices, bucket, rank=rank)


def fit_elemental_energies_streaming(ds: StreamingGraphDataset) -> tuple[np.ndarray, float]:
    """``train.elemental.fit_elemental_energies`` from the index: the
    minimum-norm solution pinv(A^T A) A^T y (numpy's lstsq on the dense
    design matrix, up to rounding), and the residual's standard deviation
    from y^T y, A^T y and the column sums, in blocks of bounded size."""
    A = ds.species.astype(np.float64)  # (G, S)
    y = ds.energies
    if np.isnan(y).any():
        raise ValueError("all graphs need energy targets for the elemental fit")
    S = A.shape[1]
    ata = np.zeros((S, S))
    aty = np.zeros(S)
    yty = 0.0
    ysum = 0.0
    colsum = np.zeros(S)
    n = len(y)
    step = 65536
    for lo in range(0, n, step):
        a, yy = A[lo : lo + step], y[lo : lo + step]
        ata += a.T @ a
        aty += a.T @ yy
        yty += float(yy @ yy)
        ysum += float(yy.sum())
        colsum += a.sum(axis=0)
    coeffs = np.linalg.pinv(ata) @ aty
    rss = yty - 2 * coeffs @ aty + coeffs @ ata @ coeffs
    rsum = ysum - coeffs @ colsum
    var = max(rss / n - (rsum / n) ** 2, 0.0)
    return coeffs, max(float(np.sqrt(var)), 1e-8)


def ladder_from_index(
    ds: StreamingGraphDataset, batch_size: int, num_classes: int = 3, pad_multiple: int = 128
) -> BucketLadder:
    """``BucketLadder.build`` from the index alone (no shard read): classes
    by triplet count, each with its worst-case bucket."""
    order = np.argsort(ds.sizes_t)
    assignments = np.zeros(len(ds), dtype=np.int64)
    buckets = []
    for idx in np.array_split(order, num_classes):
        if len(idx) == 0:
            continue
        assignments[idx] = len(buckets)
        buckets.append(_worst_case(ds, idx, batch_size, pad_multiple))
    return BucketLadder(buckets=tuple(buckets), assignments=assignments)


def _ladder_groups(ds, size: int, ladder: BucketLadder,
                   rng: Optional[np.random.Generator]) -> Iterator[tuple[int, list]]:
    """(class, graphs) of each batch of a size-class ladder: graphs buffer
    per class as the shards go by, a class's batch goes out when it holds
    ``size``, the leftovers at the end. The class of a graph comes from its
    place in the index, so the shards stream in order (``iter_graphs``
    without ``rng``); ``rng`` shuffles within each emitted batch and the
    order of the leftovers."""
    buffers: dict[int, list] = {}
    with contextlib.closing(ds.iter_graphs(rng=None)) as graphs:
        for pos, g in enumerate(graphs):
            ci = int(ladder.assignments[pos])
            buffers.setdefault(ci, []).append(g)
            if len(buffers[ci]) == size:
                batch = buffers.pop(ci)
                if rng is not None:
                    batch = [batch[i] for i in rng.permutation(len(batch))]
                yield ci, batch
    leftover = list(buffers.items())
    if rng is not None:
        rng.shuffle(leftover)
    yield from leftover


def stream_ladder_batches(
    ds: StreamingGraphDataset,
    batch_size: int,
    ladder: BucketLadder,
    rng: Optional[np.random.Generator] = None,
) -> Iterator[GraphBatch]:
    """Streaming batches padded per size class, in bounded memory (the
    batches of ``_ladder_groups``)."""
    for ci, graphs in _ladder_groups(ds, batch_size, ladder, rng):
        yield _padded(graphs, ladder.buckets[ci])


def stream_ladder_sharded_batches(
    ds: StreamingGraphDataset,
    per_device_batch: int,
    n_devices: int,
    ladder: BucketLadder,
    rng: Optional[np.random.Generator] = None,
    rank: Optional[int] = None,
) -> Iterator[GraphBatch]:
    """Data-parallel batches per size class: each class's global batch of
    ``per_device_batch * n_devices`` graphs is one ``stack_global_batch``
    in that class's bucket (with ``rank``, that rank's row)."""
    for ci, graphs in _ladder_groups(ds, per_device_batch * n_devices, ladder, rng):
        yield stack_global_batch(graphs, per_device_batch, n_devices, ladder.buckets[ci],
                                 rank=rank)

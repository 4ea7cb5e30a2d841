"""The port's ``GraphDataset``, ``BucketLadder`` and ``ladder_batch_iterator``
(``data/dataset.py``) against the JAX package's: the ladder's assignments,
buckets and padding efficiency, every field of every ladder batch under the
same ``rng``, and the dataset's own cache and process pool."""

import dataclasses
import os
import pickle

import numpy as np
import pytest

from torch_m3gnet_tpu.data import dataset as jax_dataset
from torch_m3gnet_tpu.data.graph import graph_from_structure as jax_graph
from torch_m3gnet_tpu_torch.data import GraphBatch, dataset
from torch_m3gnet_tpu_torch.data.graph import BATCH_INDEX_FIELDS, graph_from_structure

from test_torch_run import CUTOFF, CUTOFF3, as_port, cu_structures


def both_graphs(structs):
    return ([jax_graph(s, CUTOFF, CUTOFF3) for s in structs],
            [graph_from_structure(as_port(s), CUTOFF, CUTOFF3) for s in structs])


def assert_same_batch(got, want):
    """Every field equal; the kernel index (the port's own) absent."""
    assert got.num_graphs_real == want.num_graphs_real
    for f in dataclasses.fields(GraphBatch):
        a = getattr(got, f.name)
        if f.name in BATCH_INDEX_FIELDS + ("edge_reverse",):  # the port's own, not asked for
            assert a is None, f.name
            continue
        b = getattr(want, f.name)
        if b is None or isinstance(b, int):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)


@pytest.mark.parametrize("num_classes, batch_size, pad_multiple",
                         [(2, 3, 32), (3, 2, 16), (4, 5, 128)])
def test_bucket_ladder_matches_jax(num_classes, batch_size, pad_multiple):
    jgraphs, graphs = both_graphs(cu_structures(17, seed=3))
    got = dataset.BucketLadder.build(graphs, batch_size, num_classes, pad_multiple)
    want = jax_dataset.BucketLadder.build(jgraphs, batch_size, num_classes, pad_multiple)
    np.testing.assert_array_equal(got.assignments, want.assignments)
    assert [dataclasses.asdict(b) for b in got.buckets] == \
        [dataclasses.asdict(b) for b in want.buckets]
    assert len(got.buckets) == min(num_classes, 17)
    eff = got.padding_efficiency(graphs, batch_size)
    assert eff == want.padding_efficiency(jgraphs, batch_size)
    assert 0 < eff <= 1
    single = dataset.BucketSpec.for_batches(graphs, batch_size, pad_multiple)
    slots = -(-len(graphs) // batch_size) * single.max_triplets
    assert eff >= sum(g.num_triplets for g in graphs) / slots  # the ladder pads less


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_ladder_batches_match_jax(seed):
    jgraphs, graphs = both_graphs(cu_structures(13, seed=4))
    ladder = dataset.BucketLadder.build(graphs, 3, 3, 32)
    jladder = jax_dataset.BucketLadder.build(jgraphs, 3, 3, 32)
    rng = None if seed is None else np.random.default_rng(seed)
    jrng = None if seed is None else np.random.default_rng(seed)
    for epoch in range(2):  # the second epoch continues the same rng
        got = list(dataset.ladder_batch_iterator(graphs, 3, ladder, rng))
        want = list(jax_dataset.ladder_batch_iterator(jgraphs, 3, jladder, jrng))
        assert len(got) == len(want) == 6  # classes of 5, 4, 4 graphs
        for g, w in zip(got, want):
            assert_same_batch(g, w)
        assert {b.num_triplets for b in got} == {b.max_triplets for b in ladder.buckets}


def test_graph_dataset_cache_and_pool(tmp_path):
    """Built in one process and in two spawned workers: the same graphs.
    The port's cache is hit (a second dataset of the same key builds
    nothing), and the JAX cache of the same key beside it is never read."""
    structs = [as_port(s) for s in cu_structures(9, seed=5)]
    cache = str(tmp_path / "cache")
    ds = dataset.GraphDataset(structs, CUTOFF, CUTOFF3, cache_dir=cache, name="train")
    direct = [graph_from_structure(s, CUTOFF, CUTOFF3) for s in structs]
    port_file = os.path.basename(ds.cache_path)
    assert len(ds) == 9 and port_file.startswith("torch_graphs_train_")
    jax_ds = jax_dataset.GraphDataset(cu_structures(9, seed=5), CUTOFF, CUTOFF3,
                                      cache_dir=cache, name="train")
    jax_file = f"graphs_train_{port_file[-12:-4]}.pkl"  # the same key
    with open(os.path.join(cache, jax_file), "rb") as f:
        assert len(pickle.load(f)) == 9
    with open(os.path.join(cache, jax_file), "wb") as f:
        f.write(b"not a pickle")  # a port that opened it would fail

    # Cache hit: structures that could not be built.
    hit = dataset.GraphDataset([None] * 9, CUTOFF, CUTOFF3, cache_dir=cache, name="train")
    pooled = dataset.GraphDataset(structs, CUTOFF, CUTOFF3, cache_dir=cache, name="val",
                                  num_workers=2)
    for graphs in (ds.graphs, hit.graphs, pooled.graphs):
        assert len(graphs) == 9
        for g, w in zip(graphs, direct):
            assert_same_batch(g, w)
    for g, w in zip(direct, jax_ds.graphs):
        assert_same_batch(g, w)
    assert sorted(os.listdir(cache)) == sorted(
        [jax_file, port_file, os.path.basename(pooled.cache_path)])
    for _ in range(2):  # an empty split: built, cached, then read back
        assert len(dataset.GraphDataset([], CUTOFF, CUTOFF3, cache_dir=cache, name="empty")) == 0

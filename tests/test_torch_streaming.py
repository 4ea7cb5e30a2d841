"""The port's streaming dataset (``data/streaming.py``) against the JAX
package's: a shard cache written by either package opens in the other,
graph and batch streams come in the same order under the same ``rng``, the
ladder from the index and the streaming elemental fit are the same; and an
abandoned iterator frees its shard thread."""

import dataclasses
import threading
import time

import numpy as np
import pytest

from torch_m3gnet_tpu.data import streaming as jax_streaming
from torch_m3gnet_tpu_torch.data import streaming

from test_torch_dataset import assert_same_batch
from test_torch_run import CUTOFF, CUTOFF3, as_port, cu_structures

SHARD = 4


def open_both(tmp_path, structs, writer):
    """(port dataset, JAX dataset) of one cache, written by ``writer``
    ("port" or "jax") and opened by the other with ``structures=None``."""
    cache = str(tmp_path / "cache")
    kw = dict(cache_dir=cache, name="train", shard_size=SHARD)
    if writer == "port":
        ds = streaming.StreamingGraphDataset([as_port(s) for s in structs], CUTOFF, CUTOFF3, **kw)
        jds = jax_streaming.StreamingGraphDataset(None, CUTOFF, CUTOFF3,
                                                  expected_count=len(structs), **kw)
    else:
        jds = jax_streaming.StreamingGraphDataset(structs, CUTOFF, CUTOFF3, **kw)
        ds = streaming.StreamingGraphDataset(None, CUTOFF, CUTOFF3,
                                             expected_count=len(structs), **kw)
    assert ds.dir == jds.dir
    return ds, jds


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_opens_in_the_other_package(tmp_path, writer):
    structs = cu_structures(11, seed=6)
    ds, jds = open_both(tmp_path, structs, writer)
    assert len(ds) == len(jds) == 11 and ds.n_shards == jds.n_shards == 3
    assert ds.meta == jds.meta
    for name in ("sizes_n", "sizes_e", "sizes_t", "energies", "species"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name), err_msg=name)
    got, want = list(ds.iter_graphs()), list(jds.iter_graphs())
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert_same_batch(g, w)
    assert dataclasses.asdict(ds.bucket(3, 32)) == dataclasses.asdict(jds.bucket(3, 32))
    with pytest.raises(FileNotFoundError):
        streaming.StreamingGraphDataset(None, CUTOFF, CUTOFF3, str(tmp_path / "none"))


@pytest.mark.parametrize("seed", [0, 3])
def test_streams_match_jax(tmp_path, seed):
    """Under the same ``rng``, two epochs each: ``iter_graphs``,
    ``stream_batches`` (with and without ``drop_last``), the ladder from
    the index and ``stream_ladder_batches``."""
    ds, jds = open_both(tmp_path, cu_structures(14, seed=7), "port")
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):
        got, want = list(ds.iter_graphs(rng)), list(jds.iter_graphs(jrng))
        assert len(got) == 14
        for g, w in zip(got, want):
            assert_same_batch(g, w)
    bucket = ds.bucket(3, 32)
    for drop_last in (False, True):
        got = list(streaming.stream_batches(ds, 3, bucket, rng, drop_last))
        want = list(jax_streaming.stream_batches(jds, 3, jds.bucket(3, 32), jrng, drop_last))
        assert len(got) == len(want) == (4 if drop_last else 5)
        for g, w in zip(got, want):
            assert_same_batch(g, w)
    for classes in (2, 3):
        ladder = streaming.ladder_from_index(ds, 3, classes, 32)
        jladder = jax_streaming.ladder_from_index(jds, 3, classes, 32)
        np.testing.assert_array_equal(ladder.assignments, jladder.assignments)
        assert ladder.buckets == tuple(type(ladder.buckets[0])(**dataclasses.asdict(b))
                                       for b in jladder.buckets)
        for _ in range(2):
            got = list(streaming.stream_ladder_batches(ds, 3, ladder, rng))
            want = list(jax_streaming.stream_ladder_batches(jds, 3, jladder, jrng))
            assert len(got) == len(want) and sum(b.num_graphs_real for b in got) == 14
            for g, w in zip(got, want):
                assert_same_batch(g, w)


def test_elemental_fit_matches_jax(tmp_path):
    """Two species, so the fit has more than one column."""
    structs = cu_structures(13, seed=8)
    for s in structs[::3]:
        s.atomic_numbers[0] = 13
    ds, jds = open_both(tmp_path, structs, "jax")
    got, got_scale = streaming.fit_elemental_energies_streaming(ds)
    want, want_scale = jax_streaming.fit_elemental_energies_streaming(jds)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got_scale == pytest.approx(want_scale, rel=1e-12)
    assert np.count_nonzero(np.abs(got) > 1e-6) == 2
    nan = streaming.StreamingGraphDataset(
        [as_port(s) for s in cu_structures(3, seed=9, with_targets=False)], CUTOFF, CUTOFF3,
        str(tmp_path / "nan"), shard_size=SHARD)
    with pytest.raises(ValueError, match="energy targets"):
        streaming.fit_elemental_energies_streaming(nan)


def test_abandoned_iterator_frees_its_thread(tmp_path):
    """The consumer stops after one graph of a 12-shard stream: the shard
    thread, blocked on a full queue, ends within 1 s once the iterator is
    closed or dropped."""
    ds, _ = open_both(tmp_path, cu_structures(48, seed=10), "port")
    baseline = threading.active_count()
    for finish in ("close", "drop"):
        it = ds.iter_graphs(np.random.default_rng(0), prefetch=1)
        next(it)
        time.sleep(0.2)  # the producer fills the queue and blocks
        assert threading.active_count() == baseline + 1
        if finish == "close":
            it.close()
        else:
            del it
        deadline = time.monotonic() + 1.0
        while threading.active_count() > baseline and time.monotonic() < deadline:
            time.sleep(0.01)
        assert threading.active_count() == baseline, finish


def test_producer_error_reaches_the_consumer(tmp_path):
    ds, _ = open_both(tmp_path, cu_structures(9, seed=11), "port")
    with open(f"{ds.dir}/shard_00001.npz", "wb") as f:
        f.write(b"bad")  # np.load refuses it (no pickle allowed)
    it = ds.iter_graphs()
    assert len([next(it) for _ in range(SHARD)]) == SHARD
    with pytest.raises(ValueError, match="pickled data"):
        list(it)

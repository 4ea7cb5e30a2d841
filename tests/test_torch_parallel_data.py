"""The host half of the port's parallel slice against the JAX package's,
with no rank spawned: the partitioner (``partition_graph`` with and
without the halo plan, ``spatial_reorder`` by both methods,
``stack_partitions``, ``halo_stats``) bit for bit at S = 4; ``to_torch``'s
rules for a shard; the dp batches that each rank builds (its row of
``sharded_batch_iterator``, ``stack_global_batch`` and both streaming
iterators, and ``HostShardView``) against the rows of JAX's stacks; the
set-up of the process group and the mesh; and, in two small spawned jobs,
the rank launcher's errors.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.data import streaming as jax_streaming
from torch_m3gnet_tpu.data.dataset import BucketSpec as JaxBucketSpec
from torch_m3gnet_tpu.data.dataset import sharded_batch_iterator as jax_sharded
from torch_m3gnet_tpu.data.dataset import stack_global_batch as jax_stack_global
from torch_m3gnet_tpu.parallel import dp as jax_dp
from torch_m3gnet_tpu.parallel import graph_shard as jax_gs
from torch_m3gnet_tpu_torch.data import streaming
from torch_m3gnet_tpu_torch.data.dataset import BucketSpec, sharded_batch_iterator
from torch_m3gnet_tpu_torch.data.dataset import stack_global_batch
from torch_m3gnet_tpu_torch.data.graph import STATIC_FIELDS, GraphBatch, to_torch
from torch_m3gnet_tpu_torch.parallel import distributed, dp, graph_shard, launch, make_mesh

from test_torch_parallel_gp import cu_cell, graphs, shuffled
from test_torch_run import CUTOFF, CUTOFF3, cu_structures, graphs_f64

ARRAYS = [f.name for f in dataclasses.fields(GraphBatch)
          if f.name not in STATIC_FIELDS and not f.name.endswith(("_offsets", "_order"))]


def assert_same_batch(got, want):
    """Every array field bitwise equal (dtype too), the static fields equal."""
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            w = np.asarray(w)
            assert np.asarray(g).dtype == w.dtype, name
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)
    assert tuple(got.halo_offsets) == tuple(want.halo_offsets)
    assert got.num_graphs_real == want.num_graphs_real


def jax_row(stacked, i):
    import jax

    return jax.tree.map(lambda x: np.asarray(x)[i], stacked)


COMPACT = functools.partial(cu_cell, (3, 3, 2), 0, 0.05)
ROD = functools.partial(cu_cell, (1, 1, 16), 3, 0.03)


@pytest.mark.parametrize("cell,kw", [
    (COMPACT, {}), (COMPACT, dict(halo=False)), (ROD, {}), (ROD, dict(pad_multiple=32)),
    (COMPACT, dict(nodes_per_shard=24, edges_per_shard=1024, triplets_per_shard=16384,
                   halo_size=64, halo_per_pair=32, halo_offsets=(1, 2, 3))),
], ids=["compact", "compact-allgather", "rod", "rod-pad32", "given-sizes"])
def test_partition_graph_matches_jax(cell, kw):
    jg, g = graphs(cell())
    assert_same_batch(graph_shard.partition_graph(g, 4, **kw), jax_gs.partition_graph(jg, 4, **kw))


@pytest.mark.parametrize("method", ["axis", "morton"])
def test_spatial_reorder_matches_jax(method):
    """A shuffled rod reordered: the graph, the permutation, and the halo
    that its partition needs (boundary-sized again)."""
    jg, g = graphs(shuffled(ROD(), 5))
    got, perm = graph_shard.spatial_reorder(g, method)
    want, jperm = jax_gs.spatial_reorder(jg, method)
    np.testing.assert_array_equal(perm, jperm)
    assert_same_batch(got, want)
    bad = graph_shard.halo_stats(graph_shard.partition_graph(g, 4))["halo_rows_per_shard"]
    fixed = graph_shard.halo_stats(graph_shard.partition_graph(got, 4))
    assert fixed == jax_gs.halo_stats(jax_gs.partition_graph(want, 4))
    assert fixed["halo_rows_per_shard"] < bad


@pytest.mark.parametrize("halo", [True, False], ids=["halo", "allgather"])
def test_stack_partitions_matches_jax(halo):
    pairs = [graphs(cu_cell((3, 3, 2), seed, 0.05)) for seed in (11, 12)]
    got = graph_shard.stack_partitions([p[1] for p in pairs], 4, halo=halo)
    want = jax_gs.stack_partitions([p[0] for p in pairs], 4, halo=halo)
    assert np.asarray(got.positions).shape[:2] == (2, 4)
    assert_same_batch(got, want)


def test_halo_stats_matches_jax():
    """The rod at S = 4: two ring offsets, fewer rows than an all-gather."""
    jg, g = graphs(ROD())
    got = graph_shard.halo_stats(graph_shard.partition_graph(g, 4))
    assert got == jax_gs.halo_stats(jax_gs.partition_graph(jg, 4))
    assert got["n_offsets"] == 2 and got["comm_fraction_of_all_gather"] < 1.0
    with pytest.raises(ValueError, match="no halo plan"):
        graph_shard.halo_stats(graph_shard.partition_graph(g, 4, halo=False))


def _shard(halo=True):
    _, g = graphs(COMPACT())
    return graph_shard.partition_graph(g, 4, halo=halo).row(1)


@pytest.mark.parametrize("field,value,match", [
    (None, None, None),
    ("edge_dst", "ext", r"edge_dst holds a node index outside \[0, "),
    ("triplet_node_k", "ext", r"triplet_node_k holds a node index outside"),
    ("halo_send_idx", "nps", r"halo_send_idx holds a row outside \[0, 24\)"),
    ("halo_recv_idx", "rows", r"halo_recv_idx holds a row outside"),
    ("edge_src", "nps", r"edge_src holds a node index outside \[0, 24\)"),
], ids=["accepted", "dst", "node_k", "send", "recv", "src"])
def test_to_torch_rules_of_a_shard(field, value, match):
    """A shard's ids: sources local in [0, nps), destinations and k-nodes
    extended-local in [0, nps + H), send rows in [0, nps), receive slots in
    [0, n_offsets * Hp); the halo plan is carried over to the tensors."""
    shard = _shard()
    nps, h = shard.num_nodes, shard.halo_recv_idx.size
    if field is None:
        t = to_torch(shard, "cpu")
        assert t.halo_offsets == shard.halo_offsets and t.halo_send_idx.dtype.itemsize == 4
        np.testing.assert_array_equal(t.halo_recv_idx.numpy(), shard.halo_recv_idx)
        assert int(np.asarray(shard.edge_dst).max()) >= nps  # the halo is read
        return
    bad = np.array(getattr(shard, field))
    bad[-1] = {"ext": nps + h, "nps": nps, "rows": shard.halo_send_idx.size}[value]
    with pytest.raises(ValueError, match=match):
        to_torch(shard.replace(**{field: bad}), "cpu")


def test_to_torch_allgather_shard_needs_its_node_count():
    """A shard of the all-gather partition addresses global node ids: its
    check takes the global count (``num_dst_nodes``), and without it the
    ids are out of range."""
    shard = _shard(halo=False)
    with pytest.raises(ValueError, match="edge_dst holds a node index outside"):
        to_torch(shard, "cpu")
    to_torch(shard, "cpu", num_dst_nodes=4 * shard.num_nodes)


def test_shard_stack_and_unshard_match_jax():
    jgraphs, graphs_ = graphs_f64(cu_structures(4, seed=3))
    jb = JaxBucketSpec.for_batches(jgraphs, 1, 32)
    b = BucketSpec(jb.max_nodes, jb.max_edges, jb.max_triplets, jb.max_graphs)
    from torch_m3gnet_tpu.data.graph import pad_batch as jax_pad
    from torch_m3gnet_tpu_torch.data.graph import pad_batch

    want = jax_dp.shard_stack([jax_pad(g, *dataclasses.astuple(jb)) for g in jgraphs])
    got = dp.shard_stack([pad_batch(g, *dataclasses.astuple(b)) for g in graphs_])
    assert_same_batch(got, want)
    assert_same_batch(dp.unshard(got), jax_dp.unshard(want))


@pytest.mark.parametrize("n", [8, 5], ids=["full", "tail"])
def test_sharded_batch_rows_match_jax(n):
    """Each rank's row of every global batch (2 ranks x 2 graphs, shuffled
    from one seed) is row ``rank`` of JAX's stack; a short tail leaves the
    last row fully padded, every mask zero, the real count in every row."""
    jgraphs, graphs_ = graphs_f64(cu_structures(n, seed=1))
    jb = JaxBucketSpec.for_batches(jgraphs, 2, 32)
    b = BucketSpec(jb.max_nodes, jb.max_edges, jb.max_triplets, jb.max_graphs)
    want = list(jax_sharded(jgraphs, 2, 2, jb, rng=np.random.default_rng(0)))
    for rank in range(2):
        got = list(sharded_batch_iterator(graphs_, 2, 2, b, rng=np.random.default_rng(0),
                                          rank=rank))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_batch(g, jax_row(w, rank))
    stacked = list(sharded_batch_iterator(graphs_, 2, 2, b, rng=np.random.default_rng(0)))
    for g, w in zip(stacked, want):
        assert_same_batch(g, w)
    tail = stack_global_batch(graphs_[:3], 2, 2, b, rank=1)
    assert_same_batch(tail, jax_row(jax_stack_global(jgraphs[:3], 2, 2, jb), 1))
    assert not np.asarray(tail.graph_mask)[1:].any() and tail.num_graphs_real == 3


@pytest.fixture
def stream(tmp_path):
    """A shard cache of 22 graphs (6 a shard) written by JAX, opened by the
    port."""
    structs = cu_structures(22, seed=11)
    jds = jax_streaming.StreamingGraphDataset(structs, CUTOFF, CUTOFF3,
                                              cache_dir=str(tmp_path), shard_size=6)
    ds = streaming.StreamingGraphDataset(None, CUTOFF, CUTOFF3, cache_dir=str(tmp_path),
                                         shard_size=6, expected_count=22)
    return jds, ds


@pytest.mark.parametrize("ladder", [False, True], ids=["one-bucket", "ladder"])
def test_stream_sharded_rows_match_jax(stream, ladder):
    """``stream_sharded_batches`` and ``stream_ladder_sharded_batches``:
    with one rng seed, each rank's row of every yield is JAX's."""
    jds, ds = stream
    if ladder:
        jl = jax_streaming.ladder_from_index(jds, 2, num_classes=2, pad_multiple=32)
        lad = streaming.ladder_from_index(ds, 2, num_classes=2, pad_multiple=32)
        want = list(jax_streaming.stream_ladder_sharded_batches(
            jds, 2, 4, jl, rng=np.random.default_rng(0)))
        rows = [list(streaming.stream_ladder_sharded_batches(
            ds, 2, 4, lad, rng=np.random.default_rng(0), rank=r)) for r in range(4)]
    else:
        jb = jds.bucket(3, pad_multiple=32)
        b = ds.bucket(3, pad_multiple=32)
        want = list(jax_streaming.stream_sharded_batches(
            jds, 3, 4, jb, rng=np.random.default_rng(0)))
        rows = [list(streaming.stream_sharded_batches(ds, 3, 4, b, rng=np.random.default_rng(0),
                                                      rank=r)) for r in range(4)]
    for r in range(4):
        assert len(rows[r]) == len(want)
        for g, w in zip(rows[r], want):
            assert_same_batch(g, jax_row(w, r))


def test_host_shard_view_matches_jax(stream):
    """Each host's stride of shards: its length, index arrays, bucket and
    graphs."""
    jds, ds = stream
    for host in range(2):
        jv, v = jax_streaming.HostShardView(jds, host, 2), streaming.HostShardView(ds, host, 2)
        assert len(v) == len(jv) and v.shard_ids == jv.shard_ids
        for name in ("sizes_n", "sizes_e", "sizes_t", "energies", "species"):
            np.testing.assert_array_equal(getattr(v, name), getattr(jv, name))
        assert dataclasses.astuple(v.bucket(3, 32)) == dataclasses.astuple(jv.bucket(3, 32))
        for g, w in zip(v.iter_graphs(), jv.iter_graphs()):
            assert_same_batch(g, w)
    with pytest.raises(ValueError, match="host_id 2 not in"):
        streaming.HostShardView(ds, 2, 2)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(2, "dp", "cpu")


def test_initialize_reads_the_jax_variables(monkeypatch):
    """``initialize`` from JAX's COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID (gloo on the CPU, NCCL on the card unless asked, its card
    bound first: ``cuda:rank`` without LOCAL_RANK), and raises without a
    world size."""
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="world size"):
        distributed.initialize()
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    distributed.initialize(platform="cpu")
    distributed.initialize()
    card = torch.device("cuda", 1)
    assert calls == [("gloo", dict(init_method="tcp://localhost:1234", world_size=2, rank=1)),
                     ("set_device", card),
                     ("nccl", dict(init_method="tcp://localhost:1234", world_size=2, rank=1,
                                   device_id=card))]


def test_launch_reports_the_failing_rank():
    """Rank 1 raises while rank 0 waits in a barrier: the job stops both
    and reports rank 1's traceback (rank 0's barrier may fail first)."""
    with pytest.raises(RuntimeError, match=r"(?s)ranks \[.*\] exited with codes.*"
                                           r"ValueError: rank 1 fails on purpose"):
        launch.run("tests._torch_parallel_ranks:raise_on", 2, 1, timeout_s=120)


def test_launch_times_out():
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] still running"):
        launch.run("tests._torch_parallel_ranks:sleep", 2, 60.0, timeout_s=5)

"""The port's host data layer (torch_m3gnet_tpu_torch.data) against the JAX
package's: the same structures pack into identical arrays, field by field.

The fixtures are under 48 atoms, so the JAX side takes its numpy neighbour
list, the one the port copies.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu_torch.data import GraphBatch, Structure, pack_structures, to_torch
from torch_m3gnet_tpu_torch.data.graph import BATCH_INDEX_FIELDS
from torch_m3gnet_tpu_torch.utils import profiling




def _port_structure(s):
    return Structure(s.lattice, s.cart_coords, s.atomic_numbers)


@pytest.mark.parametrize(
    "names, pad",
    [
        (("al_fcc",), {}),
        (("na_bcc",), {}),
        (("tio2_rutile",), {}),
        (("al_fcc", "na_bcc", "tio2_rutile"), dict(max_graphs=4, pad_multiple=64)),
    ],
    ids=["al", "na", "tio2", "all-padded"],
)
def test_pack_structures_matches_jax(request, names, pad):
    structs = [request.getfixturevalue(n) for n in names]
    want = jax_pack(structs, 5.0, 4.0, **pad)
    got = pack_structures([_port_structure(s) for s in structs], 5.0, 4.0, **pad)
    for f in dataclasses.fields(GraphBatch):
        g = getattr(got, f.name)
        if f.name in BATCH_INDEX_FIELDS + ("edge_reverse",):  # the port's own, not asked for
            assert g is None, f.name
            continue
        w = getattr(want, f.name)
        if w is None or isinstance(w, (int, tuple)):  # absent, or a static field
            assert g == w, f.name
            continue
        assert g.dtype == np.asarray(w).dtype, f.name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f.name)


def test_to_torch_index_fields_are_int32_and_checked(al_fcc, na_bcc):
    batch = pack_structures([_port_structure(al_fcc), _port_structure(na_bcc)], 5.0, 4.0)
    t = to_torch(batch, "cpu", torch.float64)
    for name in ("atom_types", "node_graph", "edge_src", "edge_dst", "triplet_e1", "n_node"):
        x = getattr(t, name)
        assert x.dtype == torch.int32 and x.is_contiguous(), name
    assert t.positions.dtype == torch.float64 and t.edge_mask.dtype == torch.bool
    assert to_torch(t, "cpu").edge_src is t.edge_src  # already in place: not copied

    unsorted = batch.replace(edge_src=batch.edge_src[::-1].copy())
    with pytest.raises(ValueError, match="sorted"):
        to_torch(unsorted, "cpu")
    out_of_range = batch.replace(edge_dst=batch.edge_dst + batch.num_nodes)
    with pytest.raises(ValueError, match="outside"):
        to_torch(out_of_range, "cpu")


@pytest.mark.parametrize(
    "field, shift, match",
    [
        ("triplet_e1", "reverse", "triplet_e1 must be sorted"),
        ("triplet_e1", "past-end", "triplet_e1 holds an edge index outside"),
        ("triplet_e2", "past-end", "triplet_e2 holds an edge index outside"),
        ("triplet_e2", "negative", "triplet_e2 holds an edge index outside"),
    ],
    ids=["e1-unsorted", "e1-range", "e2-range", "e2-negative"],
)
def test_to_torch_checks_triplet_indices(al_fcc, field, shift, match):
    """The fused-triplet kernel searches the sorted triplet_e1 and both
    triplet kernels index edges by e1 and e2: a host batch that breaks
    either is refused before it reaches a device."""
    batch = pack_structures([_port_structure(al_fcc)], 5.0, 4.0)
    idx = getattr(batch, field)
    bad = {
        "reverse": idx[::-1].copy(),
        "past-end": idx + batch.num_edges,
        "negative": idx - batch.num_edges,
    }[shift]
    to_torch(batch, "cpu")  # the packed batch itself passes
    with pytest.raises(ValueError, match=match):
        to_torch(batch.replace(**{field: bad}), "cpu")


@pytest.mark.parametrize(
    "bad, match",
    [("reverse", "node_graph must be sorted"), ("past-end", "node_graph holds a graph index"),
     ("negative", "node_graph holds a graph index")],
    ids=["unsorted", "range", "negative"],
)
def test_to_torch_checks_node_graph(al_fcc, na_bcc, bad, match):
    """The strain stress sums by edge_graph = node_graph[edge_src], sorted
    only if node_graph is: a host batch that breaks that is refused."""
    batch = pack_structures([_port_structure(al_fcc), _port_structure(na_bcc)], 5.0, 4.0,
                            max_graphs=3)
    ng = batch.node_graph
    to_torch(batch, "cpu")  # the packed batch itself passes
    node_graph = {"reverse": ng[::-1].copy(), "past-end": ng + 3, "negative": ng - 1}[bad]
    with pytest.raises(ValueError, match=match):
        to_torch(batch.replace(node_graph=node_graph), "cpu")


def _halo(batch):
    """``batch`` as one shard with a halo plan: 2 ring offsets of 2 sent
    rows, 4 halo slots, so destinations lie in [0, N + 4)."""
    return batch.replace(halo_send_idx=np.arange(4, dtype=np.int32),
                         halo_recv_idx=np.arange(4, dtype=np.int32)[::-1].copy(),
                         halo_offsets=(1, 2))


def _set(a, i, value, dtype=None):
    out = np.array(a, dtype=dtype or a.dtype)
    out[i] = value
    return out


# (field breaks its rule, the message, in the order the rules are checked),
# each a function of the packed batch b with N nodes, E edges, B graphs;
# "halo" cases run on _halo(b).
RULE_CASES = {
    "halo-blocks": (True, lambda b: {"halo_send_idx": np.arange(3, dtype=np.int32)},
                    lambda b: "halo_send_idx holds 3 rows, not one block per ring offset "
                              "of (1, 2)"),
    "halo-send-range": (True, lambda b: {"halo_send_idx": _set(np.arange(4), 3, b.num_nodes,
                                                               np.int32)},
                        lambda b: f"halo_send_idx holds a row outside [0, {b.num_nodes})"),
    "halo-recv-range": (True, lambda b: {"halo_recv_idx": _set(np.arange(4), 0, -1, np.int32)},
                        lambda b: "halo_recv_idx holds a row outside [0, 4)"),
    "src-order": (False, lambda b: {"edge_src": _set(b.edge_src, 0, b.edge_src[1] + 1)},
                  lambda b: "edge_src must be sorted ascending"),
    "src-range": (False, lambda b: {"edge_src": _set(b.edge_src, -1, b.num_nodes)},
                  lambda b: f"edge_src holds a node index outside [0, {b.num_nodes})"),
    "dst-range": (False, lambda b: {"edge_dst": _set(b.edge_dst, 0, -1)},
                  lambda b: f"edge_dst holds a node index outside [0, {b.num_nodes})"),
    "dst-range-halo": (True, lambda b: {"edge_dst": _set(b.edge_dst, -1, b.num_nodes + 4)},
                       lambda b: f"edge_dst holds a node index outside [0, {b.num_nodes + 4})"),
    "node-k-range": (False, lambda b: {"triplet_node_k": _set(b.triplet_node_k, 5, b.num_nodes)},
                     lambda b: f"triplet_node_k holds a node index outside [0, {b.num_nodes})"),
    "e1-order": (False, lambda b: {"triplet_e1": _set(b.triplet_e1, -1, b.triplet_e1[-2] - 1)},
                 lambda b: "triplet_e1 must be sorted ascending"),
    "e1-range": (False, lambda b: {"triplet_e1": _set(b.triplet_e1, -1, b.num_edges)},
                 lambda b: f"triplet_e1 holds an edge index outside [0, {b.num_edges})"),
    "e2-range": (False, lambda b: {"triplet_e2": _set(b.triplet_e2, 7, -3)},
                 lambda b: f"triplet_e2 holds an edge index outside [0, {b.num_edges})"),
    "graph-order": (False, lambda b: {"node_graph": _set(b.node_graph, 0, 1)},
                    lambda b: "node_graph must be sorted ascending"),
    "graph-range": (False, lambda b: {"node_graph": _set(b.node_graph, -1, 3)},
                    lambda b: "node_graph holds a graph index outside [0, 3)"),
    # int64 values that an int32 cast would wrap into range (2**32 + 1 -> 1)
    # or into disorder (2**32 -> 0 at the end of the sorted node_graph):
    # checked in their own dtype, refused by their range
    "dst-int64-wraps": (False, lambda b: {"edge_dst": _set(b.edge_dst, 4, 2**32 + 1, np.int64)},
                        lambda b: f"edge_dst holds a node index outside [0, {b.num_nodes})"),
    "graph-int64-wraps": (False, lambda b: {"node_graph": _set(b.node_graph, -1, 2**32,
                                                              np.int64)},
                          lambda b: "node_graph holds a graph index outside [0, 3)"),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_to_torch_refuses_each_rule(al_fcc, na_bcc, case):
    """Each rule of the host-batch check (ops.batch_check's plain version on
    the CPU) refuses a batch that breaks it, and only it, with its message,
    bound included; the packed batch passes, and each checked host batch
    counts once under to_torch.checks.cpu."""
    halo, bad, text = RULE_CASES[case]
    batch = pack_structures([_port_structure(al_fcc), _port_structure(na_bcc)], 5.0, 4.0,
                            max_graphs=3)
    if halo:
        batch = _halo(batch)
    before = profiling.counts().get("to_torch.checks.cpu", 0)
    to_torch(batch, "cpu")  # the packed batch itself passes
    assert profiling.counts()["to_torch.checks.cpu"] == before + 1
    with pytest.raises(ValueError, match=f"^{re.escape(text(batch))}$"):
        to_torch(batch.replace(**bad(batch)), "cpu")


def _assert_e2_order(order, offsets, e2, num_edges):
    """order is np.argsort(e2, kind="stable") and offsets the left
    searchsorted of every edge id in the sorted e2."""
    e2 = np.asarray(e2)
    want = np.argsort(e2, kind="stable")
    assert order.dtype == torch.int32 and offsets.dtype == torch.int32
    assert order.is_contiguous() and offsets.is_contiguous()
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(offsets.numpy(),
                                  np.searchsorted(e2[want], np.arange(num_edges + 1)))


@pytest.mark.parametrize(
    "names, pad",
    [
        (("al_fcc",), {}),
        (("na_bcc",), {}),
        (("tio2_rutile",), {}),
        (("al_fcc", "na_bcc", "tio2_rutile"), dict(max_graphs=4, pad_multiple=64)),
    ],
    ids=["al", "na", "tio2", "all-padded"],
)
def test_to_torch_builds_the_e2_order(request, names, pad):
    """The e2 order that the fused stage's backward kernel sums dG by:
    to_torch builds it once per batch, the stable argsort of triplet_e2 and
    the run offsets of each edge. Padded triplets point e2 at edge 0, so
    edge 0's run ends with them, in ascending t. The run offsets of the
    sorted edge_src and triplet_e1 come with it (the last node and the last
    edge own the padded tails)."""
    structs = [_port_structure(request.getfixturevalue(n)) for n in names]
    batch = pack_structures(structs, 5.0, 4.0, **pad)
    assert all(getattr(batch, name) is None for name in BATCH_INDEX_FIELDS)
    t = to_torch(batch, "cpu")
    for name, seg, s in (("edge_src_offsets", batch.edge_src, batch.num_nodes),
                         ("triplet_e1_offsets", batch.triplet_e1, batch.num_edges)):
        off = getattr(t, name)
        assert off.dtype == torch.int32 and off.is_contiguous(), name
        np.testing.assert_array_equal(off.numpy(), np.searchsorted(seg, np.arange(s + 1)))
        assert off[-1] == seg.size and off[-1] - off[-2] > 0, name
    _assert_e2_order(t.triplet_e2_order, t.triplet_e2_offsets, batch.triplet_e2, batch.num_edges)
    n_pad = int((~batch.triplet_mask).sum())
    assert n_pad > 0
    off = t.triplet_e2_offsets.numpy()
    run0 = t.triplet_e2_order.numpy()[off[0]:off[1]]
    assert off[0] == 0 and run0.size >= n_pad
    np.testing.assert_array_equal(run0[-n_pad:], np.arange(batch.num_triplets - n_pad,
                                                           batch.num_triplets))
    assert np.all(np.diff(run0) > 0)
    # an already converted batch keeps its order; a host batch with a new
    # e2 gets a new one
    assert to_torch(t, "cpu").triplet_e2_order is t.triplet_e2_order
    flipped = batch.replace(triplet_e2=batch.triplet_e2[::-1].copy())
    f = to_torch(flipped, "cpu")
    _assert_e2_order(f.triplet_e2_order, f.triplet_e2_offsets, flipped.triplet_e2,
                     batch.num_edges)


def test_to_torch_builds_the_e2_order_of_a_tensor_batch(al_fcc):
    """A tensor batch without an order gets one built on its device, from
    its own triplet_e2; edges that no triplet points at have empty runs."""
    batch = to_torch(pack_structures([_port_structure(al_fcc)], 5.0, 4.0), "cpu")
    rng = np.random.default_rng(7)
    e2 = rng.integers(0, batch.num_edges // 3, batch.num_triplets).astype(np.int32)
    bare = batch.replace(triplet_e2=torch.as_tensor(e2))
    assert all(getattr(bare, name) is None for name in BATCH_INDEX_FIELDS)
    t = to_torch(bare, "cpu")
    _assert_e2_order(t.triplet_e2_order, t.triplet_e2_offsets, e2, batch.num_edges)
    assert int(t.triplet_e2_offsets[-1]) == batch.num_triplets
    assert int(t.triplet_e2_offsets[batch.num_edges // 3]) == batch.num_triplets


@pytest.mark.parametrize("field", ["edge_src", "triplet_e1", "triplet_e2", "positions"])
def test_replace_drops_the_index_built_from_a_replaced_field(al_fcc, field):
    """Replacing edge_src, triplet_e1, triplet_e2, or the positions by ones
    of another node count, drops the whole kernel index of a converted
    batch, so to_torch builds it anew from the new fields; replacing the
    positions by the same count, or a target, keeps it."""
    batch = to_torch(pack_structures([_port_structure(al_fcc)], 5.0, 4.0), "cpu")
    assert all(getattr(batch, name) is not None for name in BATCH_INDEX_FIELDS)
    for same in (dict(positions=batch.positions * 2), dict(energy=torch.ones(1))):
        kept = batch.replace(**same)
        assert all(getattr(kept, n) is getattr(batch, n) for n in BATCH_INDEX_FIELDS)
    new = getattr(batch, field).clone()
    if field == "triplet_e2":
        new = new.flip(0)
    elif field == "positions":
        new = torch.cat([new, new[:1]])
    else:  # still sorted: the first run grows by one entry
        new[1] = new[0]
    replaced = batch.replace(**{field: new})
    assert all(getattr(replaced, name) is None for name in BATCH_INDEX_FIELDS)
    kept_given = batch.replace(**{field: new, "edge_src_offsets": batch.edge_src_offsets})
    assert kept_given.edge_src_offsets is batch.edge_src_offsets
    t = to_torch(replaced, "cpu")
    for name, seg, s in (("edge_src_offsets", t.edge_src, t.num_nodes),
                         ("triplet_e1_offsets", t.triplet_e1, t.num_edges)):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.searchsorted(seg.numpy(), np.arange(s + 1)))
    _assert_e2_order(t.triplet_e2_order, t.triplet_e2_offsets, t.triplet_e2, t.num_edges)


@pytest.mark.parametrize("index", [(), ("edge_src_offsets",), ("triplet_e1_offsets",),
                                   ("triplet_e2_order", "triplet_e2_offsets")],
                         ids=["none", "src", "e1", "e2-order"])
def test_to_torch_builds_only_the_named_index(al_fcc, index):
    """to_torch builds the named parts of the index and no other, for a
    host batch and for a tensor batch that lacks them; a tensor batch keeps
    what it carries."""
    host = pack_structures([_port_structure(al_fcc)], 5.0, 4.0)
    t = to_torch(host, "cpu", index=index)
    for name in BATCH_INDEX_FIELDS:
        assert (getattr(t, name) is not None) == (name in index), name
    full = to_torch(t, "cpu")
    assert all(getattr(full, name) is not None for name in BATCH_INDEX_FIELDS)
    for name in index:
        assert getattr(full, name) is getattr(t, name)
    assert to_torch(full, "cpu", index=index).triplet_e2_order is full.triplet_e2_order
    with pytest.raises(ValueError, match="unknown batch index"):
        to_torch(host, "cpu", index=("edge_dst_offsets",))

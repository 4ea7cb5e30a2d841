"""The port's host data layer (torch_m3gnet_tpu_torch.data) against the JAX
package's: the same structures pack into identical arrays, field by field.

The fixtures are under 48 atoms, so the JAX side takes its numpy neighbour
list, the one the port copies.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu_torch.data import GraphBatch, Structure, pack_structures, to_torch


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
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None or isinstance(w, int):
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

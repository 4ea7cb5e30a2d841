"""The port's native host data path (torch_m3gnet_tpu_torch.native) against
the JAX package's: the C++ cell-list neighbour list and triplet enumerator,
the batches built on them from 48 atoms up, ``cast_batch`` and
``triplet_counts``, and a failed build, which raises instead of falling
back to numpy.

Index arrays must be equal element for element. Distances are float64
sqrt(|r|^2) of the same cartesian differences, summed in the same order by
the same source compiled twice: within 1e-12 A (an f64 ulp at 5 A is 9e-16).
"""

import dataclasses

import numpy as np
import pytest

from torch_m3gnet_tpu import native as jax_native
from torch_m3gnet_tpu.data.graph import cast_batch as jax_cast_batch
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.graph import triplet_counts as jax_triplet_counts
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu_torch import native
from torch_m3gnet_tpu_torch.data import (
    Structure,
    cast_batch,
    compute_threebody,
    neighbor_list_pbc,
    pack_structures,
    triplet_counts,
)

DIST_TOL = 1e-12


def _cell(kind: str, seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lattice, cart_coords, Z) of a perturbed cell of at least 48 atoms."""
    rng = np.random.default_rng(seed)
    frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    if kind == "al_fcc_108":  # 3x3x3 conventional fcc Al
        lat = np.eye(3) * 4.05
        reps, z = 3, 13
    else:  # a triclinic 2x3x2 supercell of a sheared fcc cell: 48 atoms
        lat = np.array([[4.0, 0.0, 0.0], [0.8, 3.9, 0.0], [0.5, -0.6, 4.2]])
        reps, z = (2, 3, 2), 29
    s = Structure.from_frac_coords(lat, frac, [z] * 4).supercell(
        reps if isinstance(reps, tuple) else (reps,) * 3)
    pos = s.cart_coords + 0.08 * rng.standard_normal(s.cart_coords.shape)
    return s.lattice, pos, s.atomic_numbers


CELLS = ("al_fcc_108", "triclinic_48")


@pytest.mark.parametrize("kind", CELLS)
@pytest.mark.parametrize("cutoff", [4.0, 5.0])
def test_neighbor_list_matches_jax_native(kind, cutoff):
    """The port's C++ neighbour list (default path at >= 48 atoms) against
    JAX's ``neighbor_list_native`` and the port's own numpy path: equal
    indices and shifts, distances within 1e-12."""
    lat, pos, _ = _cell(kind)
    native.reset_call_counts()
    got = neighbor_list_pbc(lat, pos, cutoff)
    assert native.CALLS["neighbor_list"] == 1
    want = jax_native.neighbor_list_native(lat, pos, cutoff)
    numpy_path = neighbor_list_pbc(lat, pos, cutoff, use_native=False)
    assert native.CALLS["neighbor_list"] == 1
    for ref in (want, numpy_path):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=DIST_TOL)
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64
    assert np.all(np.diff(got[0][0]) >= 0)


@pytest.mark.parametrize("kind", CELLS)
def test_threebody_matches_jax_native(kind):
    """``m3g_threebody`` through the port against JAX's ``threebody_native``
    and the port's numpy path: the same triplets in the same order."""
    lat, pos, _ = _cell(kind)
    ei, _, dist = neighbor_list_pbc(lat, pos, 5.0)
    n = pos.shape[0]
    native.reset_call_counts()
    got = compute_threebody(n, ei, dist, 4.0)
    assert native.CALLS["threebody"] == 1
    want = jax_native.threebody_native(n, ei, dist, 4.0)
    numpy_path = compute_threebody(n, ei, dist, 4.0, use_native=False)
    assert native.CALLS["threebody"] == 1
    for ref in (want, numpy_path):
        for g, w in zip(got, ref):
            np.testing.assert_array_equal(g, w)
    assert got[0].shape[1] == got[1].sum() > 0


@pytest.mark.parametrize("kind", CELLS)
def test_pack_structures_matches_jax_above_48_atoms(kind):
    """Field by field against JAX's ``pack_structures`` on two perturbed
    cells of >= 48 atoms, where both packages take their C++ paths: every
    field equal (the float fields are the same float32 casts of the same
    f64 inputs)."""
    cells = [_cell(kind, seed) for seed in (0, 1)]
    got = pack_structures([Structure(*c) for c in cells], 5.0, 4.0, pad_multiple=64)
    want = jax_pack([JaxStructure(*c) for c in cells], 5.0, 4.0, pad_multiple=64)
    assert got.num_nodes >= 96
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name, None)
        if g is None:  # no targets; the kernel index is built by to_torch
            assert w is None, f.name
            continue
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f.name)


def test_cast_batch_and_triplet_counts_match_jax():
    """``cast_batch`` casts exactly the float fields (to float64 here) and
    keeps the rest; ``triplet_counts`` gives JAX's per-node and per-edge
    counts (padded triplets left out), which equal the enumerator's."""
    c = _cell("triclinic_48")
    got = pack_structures([Structure(*c)], 5.0, 4.0, pad_multiple=64)
    want = jax_pack([JaxStructure(*c)], 5.0, 4.0, pad_multiple=64)
    got64, want64 = cast_batch(got, np.float64), jax_cast_batch(want, np.float64)
    for f in dataclasses.fields(got64):
        g = getattr(got64, f.name)
        if g is None or f.name == "num_graphs_real":
            continue
        w = np.asarray(getattr(want64, f.name))
        assert np.asarray(g).dtype == w.dtype, f.name
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=f.name)
    assert got64.positions.dtype == np.float64 and got64.edge_src.dtype == np.int32
    for g, w in zip(triplet_counts(got), jax_triplet_counts(want)):
        np.testing.assert_array_equal(g, w)
    ei, _, dist = neighbor_list_pbc(c[0], c[1], 5.0)
    _, per_node, per_edge = compute_threebody(len(c[1]), ei, dist, 4.0)
    counts = triplet_counts(got)
    np.testing.assert_array_equal(counts[0][: len(per_node)], per_node)
    np.testing.assert_array_equal(counts[1][: len(per_edge)], per_edge)


@pytest.mark.parametrize("fault", ["no-compiler", "bad-source"])
def test_failed_build_raises_instead_of_falling_back(fault, tmp_path, monkeypatch):
    """A native path that cannot be built raises ``NativeBuildError``, both
    when it was asked for and when it was chosen (>= 48 atoms); numpy still
    runs when asked for with ``use_native=False``."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    if fault == "no-compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    else:
        bad = tmp_path / "neighbor.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SOURCE", bad)
    lat, pos, _ = _cell("triclinic_48")
    with pytest.raises(native.NativeBuildError):
        neighbor_list_pbc(lat, pos, 5.0)
    with pytest.raises(native.NativeBuildError):
        neighbor_list_pbc(np.eye(3) * 4.0, pos[:2], 5.0, use_native=True)
    ei, _, dist = neighbor_list_pbc(lat, pos, 5.0, use_native=False)
    with pytest.raises(native.NativeBuildError):
        compute_threebody(len(pos), ei, dist, 4.0)
    assert compute_threebody(len(pos), ei, dist, 4.0, use_native=False)[0].shape[1] > 0
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_goes_to_the_build_dir_only():
    """The library is built under ``torch_m3gnet_tpu_torch/_build/`` and
    nothing is written beside the source."""
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.parent.name == "_build" and path.parent.parent.name == "torch_m3gnet_tpu_torch"
    assert sorted(p.name for p in native.SOURCE.parent.iterdir()
                  if p.name != "__pycache__") == ["__init__.py", "neighbor.cpp"]

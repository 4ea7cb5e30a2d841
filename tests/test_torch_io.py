"""The port's dataset readers (``data/io.py``) against the JAX package's, on
files the test writes: an mlearn JSON (both shear orders), CIF strings
(oblique cells, uncertainty suffixes, labels and type symbols) and an MPF
block pickle of several frames per material id, CIFs and pymatgen dicts
mixed. Every field of every structure must be equal, and the split by
material id the same."""

import json
import pickle

import numpy as np
import pytest

from torch_m3gnet_tpu.data import io as jax_io
from torch_m3gnet_tpu_torch.data import io

ELEMENTS = ["Cu", "Al", "Si", "O", "Li"]


def random_cell(rng, n):
    lattice = np.diag(rng.uniform(3.0, 6.0, 3)) + 0.3 * rng.standard_normal((3, 3))
    return lattice, rng.uniform(0, 1, (n, 3)), [ELEMENTS[i] for i in rng.integers(0, 5, n)]


def pymatgen_dict(lattice, frac, symbols, key="element"):
    sites = [{"abc": list(map(float, f)), "species": [{key: s, "occu": 1}]}
             for f, s in zip(frac, symbols)]
    return {"lattice": {"matrix": lattice.tolist()}, "sites": sites}


def cif_text(rng, n, uncertainty=False, label_only=False):
    """A P1 CIF as pymatgen writes it, of an oblique cell."""
    a, b, c = rng.uniform(3.0, 6.0, 3)
    al, be, ga = rng.uniform(75, 105, 3)
    frac = rng.uniform(0, 1, (n, 3))
    syms = [ELEMENTS[i] for i in rng.integers(0, 5, n)]
    fmt = (lambda x: f"{x:.8f}(3)") if uncertainty else (lambda x: f"{x:.8f}")
    head = "\n".join([
        "# generated using pymatgen", "data_X", "_symmetry_space_group_name_H-M   'P 1'",
        f"_cell_length_a   {fmt(a)}", f"_cell_length_b   {fmt(b)}",
        f"_cell_length_c   {fmt(c)}", f"_cell_angle_alpha   {fmt(al)}",
        f"_cell_angle_beta   {fmt(be)}", f"_cell_angle_gamma   {fmt(ga)}",
        "_symmetry_Int_Tables_number   1", "_cell_formula_units_Z   1",
        "loop_", " _symmetry_equiv_pos_site_id", " _symmetry_equiv_pos_as_xyz",
        "  1  'x, y, z'", "loop_",
    ])
    cols = ([] if label_only else [" _atom_site_type_symbol"]) + [
        " _atom_site_label", " _atom_site_symmetry_multiplicity", " _atom_site_fract_x",
        " _atom_site_fract_y", " _atom_site_fract_z", " _atom_site_occupancy"]
    rows = [("" if label_only else f"  {s}") + f"  {s}{i}  1  {x:.8f}  {y:.8f}  {z:.8f}  1"
            for i, (s, (x, y, z)) in enumerate(zip(syms, frac))]
    return "\n".join([head, *cols, *rows, ""])


def assert_same_structures(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.lattice, w.lattice)
        np.testing.assert_array_equal(g.cart_coords, w.cart_coords)
        np.testing.assert_array_equal(g.atomic_numbers, w.atomic_numbers)
        assert set(g.properties) == set(w.properties)
        for k, v in w.properties.items():
            np.testing.assert_array_equal(g.properties[k], v, err_msg=k)


def test_constants_match_jax():
    assert io.KBAR_PER_EV_A3 == jax_io.KBAR_PER_EV_A3
    assert io.Z_OF == jax_io.Z_OF and len(io.Z_OF) == 103
    assert io.SHEAR_GATHERS == jax_io.SHEAR_GATHERS


@pytest.mark.parametrize("shear_order", ["voigt", "reference"])
def test_mlearn_json_matches_jax(tmp_path, shear_order):
    rng = np.random.default_rng(0)
    records = []
    for i in range(6):
        lattice, frac, syms = random_cell(rng, 2 + i)
        records.append({
            "structure": pymatgen_dict(lattice, frac, syms, "element" if i % 2 else "symbol"),
            "outputs": {"energy": float(rng.normal(-20, 3)),
                        "forces": rng.standard_normal((2 + i, 3)).tolist(),
                        "virial_stress": rng.normal(0, 30, 6).tolist()},
        })
    path = tmp_path / "training.json"
    path.write_text(json.dumps(records))
    got = io.load_mlearn_json(str(path), shear_order)
    assert_same_structures(got, jax_io.load_mlearn_json(str(path), shear_order))
    vs = np.asarray(records[0]["outputs"]["virial_stress"]) / io.KBAR_PER_EV_A3
    np.testing.assert_array_equal(got[0].properties["stress"], vs[io.SHEAR_GATHERS[shear_order]])


def test_mlearn_fixture_matches_jax():
    for name in ("training", "test"):
        path = f"tests/fixtures/synthetic_mlearn_Cu/{name}.json"
        assert_same_structures(io.load_mlearn_json(path), jax_io.load_mlearn_json(path))


@pytest.mark.parametrize("uncertainty, label_only",
                         [(False, False), (True, False), (False, True)],
                         ids=["plain", "uncertainty", "labels"])
def test_parse_cif_matches_jax(uncertainty, label_only):
    rng = np.random.default_rng(1)
    for n in (1, 3, 7):
        text = cif_text(rng, n, uncertainty, label_only)
        assert_same_structures([io.parse_cif(text)], [jax_io.parse_cif(text)])
    with pytest.raises(ValueError, match="atom_site"):
        io.parse_cif(text.split("loop_")[0])


def test_mpf_pickles_match_jax(tmp_path):
    """Two block pickles, 11 material ids of 1-4 frames each, CIF strings and
    pymatgen dicts: every structure, the kbar -> eV/A^3 Voigt stress, and
    the split by material id."""
    rng = np.random.default_rng(2)
    blocks = [{}, {}]
    frames_of = {}
    for m in range(11):
        mid = f"mp-{1000 + 37 * m}"
        n, frames = 2 + m % 3, 1 + m % 4
        structs, energy, force, stress = [], [], [], []
        for f in range(frames):
            if (m + f) % 2:
                structs.append(cif_text(rng, n))
            else:
                structs.append(pymatgen_dict(*random_cell(rng, n)))
            energy.append(float(rng.normal(-10, 2)))
            force.append(rng.standard_normal((n, 3)).tolist())
            stress.append(rng.normal(0, 20, (3, 3)).tolist())
        blocks[m % 2][mid] = {"structure": structs, "energy": energy, "force": force,
                              "stress": stress}
        frames_of[mid] = frames
    paths = []
    for i, block in enumerate(blocks):
        paths.append(str(tmp_path / f"block_{i}_cif.p"))
        with open(paths[-1], "wb") as f:
            pickle.dump(block, f)
    for val_ratio, test_ratio, seed in ((0.2, 0.2, 0), (0.1, 0.3, 5)):
        got = io.load_mpf_pickles(paths, val_ratio, test_ratio, seed)
        want = jax_io.load_mpf_pickles(paths, val_ratio, test_ratio, seed)
        for g, w in zip(got, want):
            assert_same_structures(g, w)
        assert sum(map(len, got)) == sum(frames_of.values())
    stress = np.asarray(blocks[0]["mp-1000"]["stress"][0]) / io.KBAR_PER_EV_A3
    first = [s for split in got for s in split
             if np.array_equal(s.properties["forces"], blocks[0]["mp-1000"]["force"][0])]
    np.testing.assert_array_equal(first[0].properties["stress"],
                                  stress[[0, 1, 2, 1, 2, 0], [0, 1, 2, 2, 0, 1]])

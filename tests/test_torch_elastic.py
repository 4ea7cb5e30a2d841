"""The port's second-order observables (torch_m3gnet_tpu_torch.simulate:
elastic tensor, force constants, Gamma phonons, phonon dispersion) and its
equation of state against the JAX package's, with the same weights.

A small model (2 blocks, width 8, l_max = n_max = 2) in float64. JAX
differentiates twice with ``jax.hessian`` (forward over reverse) in its
default CPU mode (its factorized mode's custom VJPs have no forward mode);
the port runs its default factorized stage with the VJP of
``torch.func.grad`` mapped by ``torch.func.vmap`` over the rows of an
identity (reverse over reverse, one batched backward, as ``jax.hessian``
maps its rows) through its Functions' vmap rules and plain versions; the
batched Hessian is also held to the row-by-row loop it replaced
(``chip_smoke.row_loop_hessian``, 1e-12). On a fixed graph built at the cutoffs the two modes compute one
function, so these are the same second derivatives in another summation
order. Tolerances: rtol 1e-7 with an
absolute floor of 1e-8 of each array's largest magnitude (the f64 energies
agree to 1e-9 relative, test_torch_model.py, and a second derivative loses
a few more digits to cancellation); frequencies within 1e-6 THz.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from torch_m3gnet_tpu import simulate as jax_sim
from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import build_model as jax_build_model
from torch_m3gnet_tpu_torch import simulate
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import Structure, cast_batch, pack_structures
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax

jax.config.update("jax_enable_x64", True)

SMALL = dict(l_max=2, n_max=2, embedding_dim=8, num_blocks=2)
FCC = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]
# Few padded nodes: JAX's hessian runs over every padded coordinate.
PAD = 8


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-8 * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def setup():
    """(JAX potential, params, port potential, JAX batch, port batch) on a
    perturbed 4-atom fcc Cu cell, both batches float64."""
    rng = np.random.default_rng(0)
    frac = np.array(FCC) + rng.normal(0, 0.01, (4, 3))
    js = JaxStructure.from_frac_coords(np.eye(3) * 3.62, frac, [29] * 4)
    s = Structure(js.lattice, js.cart_coords, js.atomic_numbers)
    jbatch = jax_pack([js], 5.0, 4.0, pad_multiple=PAD, dtype=np.float64)
    batch = pack_structures([s], 5.0, 4.0, pad_multiple=PAD, dtype=np.float64)
    jpot = jax_build_model(JaxConfig(**SMALL))
    params = jpot.init(jax.random.PRNGKey(0), jbatch)
    pot = build_model(M3GNetConfig(**SMALL), device="cpu").double()
    pot.model.load_state_dict(
        params_from_flax(jax.tree.map(np.asarray, params), dtype=torch.float64))
    return jpot, params, pot, jbatch, batch


def test_elastic_tensor_matches_jax(setup):
    """C (6, 6) in eV/A^3 and GPa, and the Voigt bulk modulus."""
    jpot, params, pot, jbatch, batch = setup
    got = simulate.elastic_tensor(pot, batch, gpa=False)
    want = jax_sim.elastic_tensor(jpot, params, jbatch, gpa=False)
    assert got.shape == (6, 6) and got.dtype == np.float64
    _close(got, want, "C")
    np.testing.assert_array_equal(got, got.T)
    gpa = simulate.elastic_tensor(pot, batch)
    _close(gpa, got * simulate.elastic.EV_PER_A3_TO_GPA)
    assert simulate.bulk_modulus_voigt(gpa) == pytest.approx(
        jax_sim.bulk_modulus_voigt(np.asarray(gpa)), rel=1e-12)


def test_force_constants_and_gamma_phonons_match_jax(setup):
    """The (N, 3, N, 3) force constants, the Gamma frequencies and the mass
    scaling of the modes; rows of the force constants sum to ~0 (acoustic
    sum rule: a uniform translation costs nothing)."""
    jpot, params, pot, jbatch, batch = setup
    masses = [63.55, 63.55, 58.69, 63.55]
    got = simulate.gamma_phonons(pot, batch, masses)
    want = jax_sim.gamma_phonons(jpot, params, jbatch, masses)
    _close(got["force_constants"], want["force_constants"], "force constants")
    np.testing.assert_allclose(got["frequencies_thz"], want["frequencies_thz"], rtol=0,
                               atol=1e-6)
    assert got["modes"].shape == (12, 4, 3)
    fc = got["force_constants"]
    assert np.abs(fc.sum(axis=2)).max() < 1e-8 * np.abs(fc).max()
    np.testing.assert_array_equal(simulate.force_constants(pot, batch), fc)


def test_phonon_dispersion_is_exact_at_commensurate_k(setup):
    """Supercell method: over the 8 wave vectors commensurate with a 2x2x2
    supercell of a 1-atom fcc Cu cell, the dispersion's 24 frequencies are
    the 24 Gamma frequencies of that supercell (within 1e-6 THz), and its
    force constants are that supercell's. (Not held to JAX here: in a
    perfect crystal JAX's gather mode differentiates its clipped cos(jik)
    at exactly -1, where jnp.clip splits the gradient.)"""
    _, _, pot, _, _ = setup
    prim = Structure(np.array([[0.0, 1.81, 1.81], [1.81, 0.0, 1.81], [1.81, 1.81, 0.0]]),
                     np.zeros((1, 3)), [29])
    k = np.array([[i, j, l] for i in (0, 0.5) for j in (0, 0.5) for l in (0, 0.5)])
    got = simulate.phonon_dispersion(pot, prim, (2, 2, 2), k, [63.55], 5.0, 4.0,
                                     pad_multiple=PAD)
    sc = cast_batch(pack_structures([prim.supercell((2, 2, 2))], 5.0, 4.0, pad_multiple=PAD),
                    np.float64)  # as phonon_dispersion packs it
    gamma = simulate.gamma_phonons(pot, sc, [63.55] * 8)
    np.testing.assert_array_equal(got["force_constants"], gamma["force_constants"])
    assert got["frequencies_thz"].shape == (8, 3)
    np.testing.assert_allclose(np.sort(got["frequencies_thz"].ravel()),
                               np.sort(gamma["frequencies_thz"]), rtol=0, atol=1e-6)


def test_energy_volume_curve_and_fit_match_jax(setup):
    """E(V) under isotropic strain against JAX's (rtol 1e-9, the potential's
    f64 agreement), and the Birch-Murnaghan fit against JAX's on the same
    synthetic curve (the same scipy fit: rel 1e-10)."""
    jpot, params, pot, jbatch, batch = setup
    strains = np.linspace(-0.03, 0.03, 5)
    vols, energies = simulate.energy_volume_curve(pot, batch, strains)
    jvols, jenergies = jax_sim.energy_volume_curve(jpot, params, jbatch, strains)
    np.testing.assert_allclose(vols, jvols, rtol=1e-14)
    np.testing.assert_allclose(energies, jenergies, rtol=1e-9)
    v = np.linspace(40, 60, 15)
    e = simulate.birch_murnaghan(v, -12.3, 48.7, 0.9, 4.6)
    np.testing.assert_array_equal(e, jax_sim.birch_murnaghan(v, -12.3, 48.7, 0.9, 4.6))
    got, want = simulate.birch_murnaghan_fit(v, e), jax_sim.birch_murnaghan_fit(v, e)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-10, abs=1e-12), key
    assert got["v0_a3"] == pytest.approx(48.7, rel=1e-8)
    with pytest.raises(ValueError):
        simulate.birch_murnaghan_fit(v, -e)


def test_second_derivatives_reject_multi_graph(setup):
    _, _, pot, _, _ = setup
    s = Structure.from_frac_coords(np.eye(3) * 4.0, [[0, 0, 0]], [29])
    b2 = pack_structures([s, s], 5.0, 4.0, pad_multiple=PAD)
    for fn in (simulate.elastic_tensor, simulate.force_constants,
               simulate.energy_volume_curve):
        with pytest.raises(ValueError):
            fn(pot, b2)


@pytest.mark.parametrize("name", ["elastic_tensor", "force_constants"])
def test_batched_hessian_equals_row_loop(setup, name, monkeypatch):
    _, _, pot, _, batch = setup
    fn = getattr(simulate, name)
    got = fn(pot, batch)
    monkeypatch.setattr(simulate.elastic, "_hessian", chip_smoke.row_loop_hessian)
    want = fn(pot, batch)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_force_constants_of_a_supercell_in_chunks(monkeypatch):
    """A 7x7x7 simple-cubic supercell (343 atoms, 1,029 Hessian rows; on
    the card one pass of every row would fold 65,856 feature rows into B8's
    grid, past its y limit) under a 256 MB budget: the rows go in chunks,
    the last one partial, and the rows at the chunk bounds equal the
    row-by-row loop (1e-12)."""
    monkeypatch.setattr(simulate.elastic, "HESSIAN_CHUNK_BYTES", 256 << 20)
    cfg = M3GNetConfig(cutoff=3.0, threebody_cutoff=3.0, **SMALL)
    pot = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).double()
    rng = np.random.default_rng(1)
    cell = Structure(np.eye(3) * 2.5, rng.normal(0, 0.02, (1, 3)), [29]).supercell((7, 7, 7))
    cell = Structure(cell.lattice, cell.cart_coords + rng.normal(0, 0.02, (343, 3)),
                     cell.atomic_numbers)
    batch = pack_structures([cell], 3.0, 3.0, pad_multiple=64, dtype=np.float64)
    n, rows = 343, 3 * 343
    chunk = simulate.elastic.hessian_chunk(pot, batch.edge_src.shape[0])
    assert 1 < chunk < rows and rows % chunk != 0 and rows * 64 > 65_535
    got = simulate.force_constants(pot, batch).reshape(rows, n, 3)
    pick = sorted({0, 1, chunk - 1, chunk, 2 * chunk, rows - rows % chunk, rows - 1})
    graph, energy = simulate.elastic._energy_fn(pot, batch)
    want = chip_smoke.row_loop_hessian(lambda p: energy(p, graph.lattice), graph.positions,
                                       pick=pick)
    want = want[:, :n].numpy()
    np.testing.assert_allclose(got[pick], want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    assert np.abs(got.sum(axis=1)).max() < 1e-8 * np.abs(got).max()

"""The port's MD (torch_m3gnet_tpu_torch.simulate.md) and trajectory
observables against the JAX package's, with the same weights.

A small model (2 blocks, width 8, l_max = n_max = 2) in float64 on both
sides: JAX's Flax tree carried over by ``params_from_flax``, the port on
the CPU through its kernels' plain versions. Both integrate the same
equations step for step, so at f64 they differ only by summation order
inside the potential (its energies agree to 1e-9 relative,
test_torch_model.py); over a few dozen steps that stays within rtol 1e-8,
atol 1e-10 (Angstrom, A/fs, eV, GPa, A^3).
"""

import io

import jax
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import build_model as jax_build_model
from torch_m3gnet_tpu.simulate import md as jax_md
from torch_m3gnet_tpu.simulate import observables as jax_obs
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import Structure, pack_structures, to_torch
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax
from torch_m3gnet_tpu_torch.simulate import md, observables

jax.config.update("jax_enable_x64", True)

SMALL = dict(l_max=2, n_max=2, embedding_dim=8, num_blocks=2)
# The port's default three-body mode on both sides: the per-triplet modes
# read a triplet list built at the 3-body cutoff at each rebuild, so they
# drop the triplets of an edge that moves inside that cutoff between
# rebuilds, where the factorized stage sees every edge.
FACTORIZED = dict(threebody_mode="factorized", layout="fm")
RTOL, ATOL = 1e-8, 1e-10
FCC = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]


def _cells(n: int = 2, seed: int = 3):
    """``n`` rattled 4-atom fcc Cu cells, as (JAX, port) Structure lists."""
    rng = np.random.default_rng(seed)
    base = JaxStructure.from_frac_coords(np.eye(3) * 3.62, FCC, [29] * 4)
    pos = [base.cart_coords + 0.1 * rng.standard_normal((4, 3)) for _ in range(n)]
    return ([JaxStructure(base.lattice, p, base.atomic_numbers) for p in pos],
            [Structure(base.lattice, p, base.atomic_numbers) for p in pos])


@pytest.fixture(scope="module")
def pots():
    """(JAX potential, its params, the port's potential with those weights)."""
    jstructs, _ = _cells()
    batch = jax_pack(jstructs, 5.0, 4.0, pad_multiple=64, dtype=np.float64)
    jpot = jax_build_model(JaxConfig(**FACTORIZED, **SMALL))
    params = jpot.init(jax.random.PRNGKey(0), batch)
    pot = build_model(M3GNetConfig(**SMALL), device="cpu").double()
    pot.model.load_state_dict(
        params_from_flax(jax.tree.map(np.asarray, params), dtype=torch.float64))
    return jpot, params, pot


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=name)


def _assert_results_match(got, want, npt=False):
    for name in ("energies", "kinetic", "temperatures", "times"):
        _close(getattr(got, name), getattr(want, name), name)
    for g, w in zip(got.structures, want.structures):
        _close(g.cart_coords, w.cart_coords, "positions")
        _close(g.lattice, w.lattice, "lattice")
        _close(g.properties["velocities"], w.properties["velocities"], "velocities")
    if npt:
        _close(got.pressures, want.pressures, "pressures")
        _close(got.volumes, want.volumes, "volumes")


def test_maxwell_boltzmann_matches_jax():
    """Initial velocities come from the host numpy generator, as in JAX:
    identical for one seed."""
    masses = md.ATOMIC_MASSES[np.array([29, 13, 8, 1])]
    got = md.maxwell_boltzmann_velocities(masses, 300.0, np.random.default_rng(5))
    want = jax_md.maxwell_boltzmann_velocities(masses, 300.0, np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(md.ATOMIC_MASSES, jax_md.ATOMIC_MASSES)


def test_nve_matches_jax_over_rebuilds(pots):
    """NVE (velocity Verlet) at 300 K over three neighbour-list rebuilds:
    per-step energies, kinetic energies, temperatures and the recorded
    trajectory, and the final positions and velocities, against JAX's
    ``run_md`` (tolerances in the module docstring)."""
    jpot, params, pot = pots
    jstructs, structs = _cells()
    cfg = dict(dt=1.0, n_steps=12, ensemble="nve", temperature=300.0, rebuild_every=4,
               seed=1, record_trajectory=True)
    want = jax_md.run_md(jpot, params, jstructs, 5.0, 4.0, jax_md.MDConfig(**cfg),
                         pad_multiple=64, dtype=np.float64)
    got = md.run_md(pot, structs, 5.0, 4.0, md.MDConfig(**cfg), pad_multiple=64,
                    dtype=np.float64)
    _assert_results_match(got, want)
    for g, w in zip(got.trajectories, want.trajectories):
        _close(g, w, "trajectory")
    assert got.energies.shape == (12, 2)
    # Velocity Verlet conserves the total energy between rebuilds (KE here
    # ~0.1 eV). A rebuild may shift it: the model's edge terms do not vanish
    # beyond its cutoff, so edges that enter or leave cutoff + skin change
    # the energy, in the JAX package as in the port (matched above).
    total = (got.energies + got.kinetic).reshape(3, 4, 2)
    assert np.abs(total - total[:, :1]).max() < 1e-7


@pytest.mark.parametrize("ensemble", ["nvt", "npt"])
def test_langevin_at_zero_temperature_matches_jax(pots, ensemble):
    """At T = 0 the BAOAB O-step is a deterministic friction (the noise
    amplitude is 0), so the port follows JAX step for step: NVT, and NPT
    with the Berendsen barostat (P_int = -tr(sigma)/3, rescaling after the
    step), from the same nonzero initial velocities, over two rebuilds."""
    jpot, params, pot = pots
    jstructs, structs = _cells()
    rng = np.random.default_rng(11)
    vel = [md.maxwell_boltzmann_velocities(np.full(4, md.ATOMIC_MASSES[29]), 300.0, rng)
           for _ in structs]
    cfg = dict(dt=1.0, n_steps=8, ensemble=ensemble, temperature=0.0, friction=0.05,
               pressure=1.0, tau_p=20.0, compressibility=1e-2, rebuild_every=4, seed=2)
    want = jax_md.run_md(jpot, params, jstructs, 5.0, 4.0, jax_md.MDConfig(**cfg),
                         velocities=vel, pad_multiple=64, dtype=np.float64)
    got = md.run_md(pot, structs, 5.0, 4.0, md.MDConfig(**cfg), velocities=vel,
                    pad_multiple=64, dtype=np.float64)
    _assert_results_match(got, want, npt=ensemble == "npt")
    if ensemble == "npt":
        assert not np.allclose(got.structures[0].lattice, structs[0].lattice)


def test_nvt_reproducible_for_one_seed(pots):
    """NVT at 300 K: two runs with one seed are bitwise equal; another seed
    gives another trajectory; temperatures stay finite."""
    _, _, pot = pots
    _, structs = _cells()
    runs = [
        md.run_md(pot, structs, 5.0, 4.0,
                  md.MDConfig(dt=1.0, n_steps=6, ensemble="nvt", temperature=300.0,
                              friction=0.05, rebuild_every=3, seed=seed),
                  pad_multiple=64, dtype=np.float64)
        for seed in (4, 4, 5)
    ]
    np.testing.assert_array_equal(runs[0].energies, runs[1].energies)
    np.testing.assert_array_equal(runs[0].structures[1].cart_coords,
                                  runs[1].structures[1].cart_coords)
    assert not np.array_equal(runs[0].energies, runs[2].energies)
    assert np.isfinite(runs[0].temperatures).all()


class _ForceFree:
    """A stand-in potential with zero energy, forces and stress."""

    def __call__(self, batch):
        class Out:
            forces = torch.zeros_like(batch.positions)
            energy = batch.positions.new_zeros(batch.num_graphs)
            stress = batch.positions.new_zeros((batch.num_graphs, 6))
        return Out()


def test_langevin_noise_variance():
    """One BAOAB step from rest with zero forces leaves v = sigma * xi with
    sigma^2 = kT/m (1 - c1^2), c1 = exp(-gamma dt): over 3 x 2,048 Cu
    velocity components the sample variance is within 6 % of it (the
    standard error of a variance over n normal samples is sqrt(2/n) = 1.8 %)
    and the mean within 5 standard errors of 0."""
    base = Structure.from_frac_coords(np.eye(3) * 3.62, FCC, [29] * 4).supercell((8, 8, 8))
    host = pack_structures([base], 2.8, 2.8, dtype=np.float64)
    batch = to_torch(host, "cpu")
    cfg = md.MDConfig(dt=2.0, ensemble="nvt", temperature=500.0, friction=0.1, seed=9)
    gen = torch.Generator().manual_seed(cfg.seed)
    vel0 = torch.zeros_like(batch.positions)
    masses = torch.as_tensor(md.node_masses(host))
    _, vel, _, _ = md._md_inner(_ForceFree(), batch, vel0, masses, gen, cfg, 1)
    v = vel[: len(base)].numpy()
    c1 = np.exp(-cfg.friction * cfg.dt)
    var = md.KB * cfg.temperature / md.KE_TO_EV / md.ATOMIC_MASSES[29] * (1 - c1 * c1)
    assert abs(v.var() / var - 1.0) < 0.06
    assert abs(v.mean()) < 5 * np.sqrt(var / v.size)


def test_observables_match_jax(tmp_path):
    """RDF (numpy path below 48 atoms, C++ cell list at 108), MSD,
    diffusion coefficient, VACF, phonon DOS and the extxyz text against the
    JAX package's on the same frames: rtol 1e-12 (the same float64 numpy
    code; the RDF histograms equal)."""
    rng = np.random.default_rng(0)
    frames = [rng.uniform(0, 9.0, (40, 3)) for _ in range(3)]
    cu = Structure.from_frac_coords(np.eye(3) * 3.62, FCC, [29] * 4).supercell((3, 3, 3))
    big = [cu.cart_coords + 0.05 * rng.standard_normal(cu.cart_coords.shape) for _ in range(2)]
    for lat, fr in ((np.eye(3) * 9.0, frames), (cu.lattice, big)):
        for got, want in zip(observables.radial_distribution(lat, fr, 5.0, 50),
                             jax_obs.radial_distribution(lat, fr, 5.0, 50)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    traj = np.cumsum(0.05 * rng.standard_normal((30, 6, 3)), axis=0)
    t, msd = observables.mean_squared_displacement(list(traj), np.arange(30) * 2.0)
    tj, msdj = jax_obs.mean_squared_displacement(list(traj), np.arange(30) * 2.0)
    np.testing.assert_allclose(msd, msdj, rtol=1e-12)
    assert observables.diffusion_coefficient(t, msd) == pytest.approx(
        jax_obs.diffusion_coefficient(tj, msdj), rel=1e-12)
    vel = list(np.diff(traj, axis=0))
    np.testing.assert_allclose(observables.velocity_autocorrelation(vel, 10),
                               jax_obs.velocity_autocorrelation(vel, 10), rtol=1e-12, atol=1e-15)
    for got, want in zip(observables.phonon_dos_from_vacf(vel, 2.0),
                         jax_obs.phonon_dos_from_vacf(vel, 2.0)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    s = Structure.from_frac_coords(np.eye(3) * 4.0, [[0, 0, 0], [0.5, 0.5, 0.5]], [13, 29])
    js = JaxStructure(s.lattice, s.cart_coords, s.atomic_numbers)
    fr = [s.cart_coords, s.cart_coords + 0.1]
    kw = dict(velocities=[np.zeros((2, 3)), np.ones((2, 3))], energies=[-1.0, -2.0],
              times=[0.0, 1.0], lattices=[s.lattice, s.lattice * 1.01])
    bufs = io.StringIO(), io.StringIO()
    observables.write_extxyz(bufs[0], s, fr, **kw)
    jax_obs.write_extxyz(bufs[1], js, fr, **kw)
    assert bufs[0].getvalue() == bufs[1].getvalue()
    observables.write_extxyz(str(tmp_path / "t.xyz"), s, fr)
    assert (tmp_path / "t.xyz").read_text().splitlines()[0] == "2"

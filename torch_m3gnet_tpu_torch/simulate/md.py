"""Batched molecular dynamics (NVE, NVT-Langevin, NPT) on the potential.

Counterpart of ``torch_m3gnet_tpu.simulate.md``, with the loop structure of
:mod:`~torch_m3gnet_tpu_torch.simulate.relax`: every structure of one padded
batch advances in lockstep; the host rebuilds the skin-padded neighbour list
every ``rebuild_every`` steps and moves the batch to the device once per
rebuild (the span ``m3gnet.md.rebuild`` while a torch profiler records);
the steps between are a Python loop of device operations with no host
synchronisation. Per-step logs go into device tensors allocated before
the loop and come back to the host once per rebuild. Forces come from one
call of the potential per step (autograd inside it), detached.

Integrators
-----------
- **NVE**: velocity Verlet, one force evaluation per step.
- **NVT**: Langevin dynamics with the BAOAB splitting (Leimkuhler &
  Matthews, J. Chem. Phys. 138, 174102 (2013)), one force evaluation per
  step. The O-step's noise comes from a ``torch.Generator`` on the batch's
  device seeded with ``MDConfig.seed`` (JAX draws it with ``jax.random``),
  so one seed gives one trajectory on one device; at temperature 0 the noise
  term vanishes and the port follows JAX step for step.
- **NPT**: the NVT-Langevin thermostat plus a Berendsen barostat
  (Berendsen et al., J. Chem. Phys. 81, 3684 (1984)), held to the JAX
  package's conventions: the internal pressure is the virial part only,
  P_int = -tr(sigma) / 3 of the potential's stress at the step's new
  positions (no kinetic term), and the barostat rescales cell and positions
  after the step's last B half-kick, so the next step starts from the forces
  of the unscaled positions. mu = clip(1 - beta dt / tau_p (P0 - P_int),
  0.98^3, 1.02^3)^(1/3) per graph.

Units: positions in Angstrom, time in fs, energies in eV, masses in amu,
temperature in K. ``FORCE_TO_ACC`` converts eV/A/amu -> A/fs^2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from torch_m3gnet_tpu_torch.data.graph import GraphBatch
from torch_m3gnet_tpu_torch.data.structure import Structure
from torch_m3gnet_tpu_torch.ops.segment import segment_sum
from torch_m3gnet_tpu_torch.simulate.relax import build_batch, device_batch, forces_stress
from torch_m3gnet_tpu_torch.utils.profiling import span

KB = 8.617333262e-5  # Boltzmann constant, eV/K
FORCE_TO_ACC = 9.648533212e-3  # (eV/A) / amu  ->  A/fs^2
KE_TO_EV = 103.642696562  # amu A^2/fs^2 -> eV
EV_A3_TO_GPA = 160.21766208  # eV/A^3 -> GPa

# Standard atomic weights (amu), index = atomic number Z (0 unused); Z <= 94.
# CODATA/IUPAC conventional values; radioactive elements use the most stable
# isotope's mass number.
ATOMIC_MASSES = np.array(
    [
        0.0, 1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999,
        18.998, 20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06,
        35.45, 39.948, 39.098, 40.078, 44.956, 47.867, 50.942, 51.996,
        54.938, 55.845, 58.933, 58.693, 63.546, 65.38, 69.723, 72.630,
        74.922, 78.971, 79.904, 83.798, 85.468, 87.62, 88.906, 91.224,
        92.906, 95.95, 97.0, 101.07, 102.91, 106.42, 107.87, 112.41,
        114.82, 118.71, 121.76, 127.60, 126.90, 131.29, 132.91, 137.33,
        138.91, 140.12, 140.91, 144.24, 145.0, 150.36, 151.96, 157.25,
        158.93, 162.50, 164.93, 167.26, 168.93, 173.05, 174.97, 178.49,
        180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59,
        204.38, 207.2, 208.98, 209.0, 210.0, 222.0, 223.0, 226.0, 227.0,
        232.04, 231.04, 238.03, 237.0, 244.0,
    ]
)


@dataclass(frozen=True)
class MDConfig:
    """MD run parameters.

    ``ensemble``: "nve" (velocity Verlet), "nvt" (Langevin BAOAB), or
    "npt" (Langevin BAOAB + Berendsen barostat).
    ``friction``: Langevin friction gamma in 1/fs (nvt/npt).
    ``pressure``: barostat target in GPa (npt).
    ``tau_p``: barostat time constant in fs; ``compressibility`` is the
    isothermal compressibility in 1/GPa (the Berendsen mu-factor uses
    compressibility * dt / tau_p: the coupling strength, not a material
    property here).
    """

    dt: float = 1.0  # fs
    n_steps: int = 100
    ensemble: str = "nve"
    temperature: float = 300.0  # K (NVT target / velocity init)
    friction: float = 0.01  # 1/fs
    pressure: float = 0.0  # GPa (npt target)
    tau_p: float = 500.0  # fs
    compressibility: float = 1e-2  # 1/GPa
    rebuild_every: int = 20
    skin: float = 0.3  # A; topology valid while no atom moves > skin/2
    seed: int = 0
    # Record per-step unwrapped positions (MDResult.trajectories) for the
    # observables (simulate/observables.py: RDF, MSD, extxyz writer).
    record_trajectory: bool = False

    def __post_init__(self):
        if self.ensemble not in ("nve", "nvt", "npt"):
            raise ValueError(f"unknown ensemble: {self.ensemble}")


@dataclass
class MDResult:
    structures: list  # final Structures (with velocities in properties)
    energies: np.ndarray  # (n_frames, B) potential energy, eV
    kinetic: np.ndarray  # (n_frames, B) kinetic energy, eV
    temperatures: np.ndarray  # (n_frames, B) instantaneous T, K
    times: np.ndarray  # (n_frames,) fs
    # per-structure (n_frames, n_i, 3) unwrapped positions when
    # record_trajectory is set, else None
    trajectories: Optional[list] = None
    # npt only: per-step internal pressure (n_frames, B) GPa and cell
    # volume (n_frames, B) A^3
    pressures: Optional[np.ndarray] = None
    volumes: Optional[np.ndarray] = None


def maxwell_boltzmann_velocities(
    masses: np.ndarray, temperature: float, rng: np.random.Generator,
    remove_drift: bool = True,
) -> np.ndarray:
    """Sample velocities (A/fs) at ``temperature`` for ``masses`` (amu)."""
    sigma = np.sqrt(KB * temperature / KE_TO_EV / masses)[:, None]  # A/fs
    v = rng.standard_normal((len(masses), 3)) * sigma
    if remove_drift and len(masses):
        p = (masses[:, None] * v).sum(axis=0)
        v = v - p / masses.sum()
    return v


def node_masses(batch: GraphBatch) -> np.ndarray:
    """(N, 1) masses (amu) of a host batch's nodes, 1 on padded nodes."""
    masses = ATOMIC_MASSES[np.asarray(batch.atom_types) + 1]  # atom_types are Z - 1
    return np.where(np.asarray(batch.node_mask), masses, 1.0)[:, None]


def _md_inner(potential, batch: GraphBatch, vel, masses, gen, cfg: MDConfig, n_steps: int):
    """``n_steps`` MD steps over the fixed topology of ``batch`` from
    velocities ``vel`` with ``masses`` (:func:`node_masses`), all on the
    device; returns (pos, vel, lat, logs) with logs the per-step (E_pot, KE,
    positions, P_int, volume) device tensors (the last three empty unless
    recorded). Nothing here copies from the host."""
    pos = batch.positions
    dtype, dev = pos.dtype, pos.device
    nmask = batch.node_mask.to(dtype)[:, None]
    gmask = batch.graph_mask.to(dtype)
    node_graph, nb = batch.node_graph.long(), batch.num_graphs
    lat = batch.lattice.to(dtype)
    dt = cfg.dt
    if cfg.ensemble in ("nvt", "npt"):
        # BAOAB O-step coefficients (exact OU solution); kT in (A/fs)^2 amu
        c1 = math.exp(-cfg.friction * dt)
        sigma = torch.sqrt(KB * cfg.temperature / KE_TO_EV / masses * (1.0 - c1 * c1))

    e_log = pos.new_zeros((n_steps, nb))
    ke_log = pos.new_zeros((n_steps, nb))
    p_log = pos.new_zeros((n_steps,) + pos.shape if cfg.record_trajectory else (0, 0, 3))
    npt_shape = (n_steps, nb) if cfg.ensemble == "npt" else (0, 0)
    press_log, vol_log = pos.new_zeros(npt_shape), pos.new_zeros(npt_shape)

    f, _, _ = forces_stress(potential, batch, pos, lat)
    for i in range(n_steps):
        acc = f / masses * FORCE_TO_ACC  # A/fs^2
        if cfg.ensemble == "nve":
            # velocity Verlet: v(t+dt/2), x(t+dt), F(t+dt), v(t+dt)
            vel = vel + 0.5 * dt * acc
            pos = pos + dt * vel * nmask
        else:
            # BAOAB: B(dt/2) A(dt/2) O(dt) A(dt/2) B(dt/2)
            vel = vel + 0.5 * dt * acc
            pos = pos + 0.5 * dt * vel * nmask
            noise = torch.randn(vel.shape, generator=gen, dtype=dtype, device=dev)
            vel = c1 * vel + sigma * noise
            pos = pos + 0.5 * dt * vel * nmask
        f, e_pot, stress = forces_stress(potential, batch, pos, lat)
        vel = vel + 0.5 * dt * (f / masses * FORCE_TO_ACC)

        if cfg.ensemble == "npt":
            p_int = -(stress[:, 0] + stress[:, 1] + stress[:, 2]) / 3.0 * EV_A3_TO_GPA  # (B,)
            base = 1.0 - (cfg.compressibility * dt / cfg.tau_p) * (cfg.pressure - p_int)
            # clamp before the cube root: a pressure spike can push the base
            # negative, and a fractional power of a negative number is NaN
            mu = torch.clamp(base, 0.98**3, 1.02**3) ** (1.0 / 3.0)
            mu = torch.where(batch.graph_mask, mu, torch.ones_like(mu))
            lat = lat * mu[:, None, None]
            pos = pos * mu[node_graph][:, None]
            press_log[i] = p_int * gmask
            vol_log[i] = torch.abs(
                (lat[:, 0] * torch.linalg.cross(lat[:, 1], lat[:, 2])).sum(-1)) * gmask

        vel = vel * nmask
        e_log[i] = e_pot
        ke = 0.5 * (masses * vel * vel).sum(-1) * KE_TO_EV * nmask[:, 0]  # (N,) eV
        ke_log[i] = segment_sum(ke, node_graph, nb)
        if cfg.record_trajectory:
            p_log[i] = pos
    return pos, vel, lat, (e_log, ke_log, p_log, press_log, vol_log)


def run_md(
    potential,
    structures: Sequence[Structure],
    cutoff: float,
    threebody_cutoff: float,
    config: MDConfig = MDConfig(),
    velocities: Optional[Sequence[np.ndarray]] = None,
    pad_multiple: int = 128,
    dtype=np.float32,
) -> MDResult:
    """Run batched MD on ``structures`` with the port's ``M3GNetPotential``,
    on its device and in its dtype (``dtype`` is that of the host graphs, as
    in the JAX package: float32 rounds the positions at each rebuild).

    If ``velocities`` is None they are drawn from Maxwell-Boltzmann at
    ``config.temperature`` with the host's numpy generator seeded by
    ``config.seed``, as the JAX package draws them. The device loop runs
    ``rebuild_every`` steps per rebuild of the (skin-padded) neighbour list.
    """
    structures = [s.wrap() for s in structures]
    rng = np.random.default_rng(config.seed)
    if velocities is None:
        velocities = [
            maxwell_boltzmann_velocities(
                ATOMIC_MASSES[np.asarray(s.atomic_numbers)], config.temperature, rng)
            for s in structures
        ]
    velocities = [np.asarray(v, dtype=np.float64) for v in velocities]

    param = next(potential.parameters())
    gen = torch.Generator(device=param.device)
    gen.manual_seed(config.seed)
    positions = [s.cart_coords.copy() for s in structures]
    lattices = [s.lattice.copy() for s in structures]
    n_outer = math.ceil(config.n_steps / config.rebuild_every)
    nsys = len(structures)
    logs_all = []

    with torch.no_grad():
        for outer in range(n_outer):
            n_steps = min(config.rebuild_every, config.n_steps - outer * config.rebuild_every)
            with span("m3gnet.md.rebuild"):
                graphs, host = build_batch(structures, positions, lattices,
                                           cutoff + config.skin, threebody_cutoff, pad_multiple,
                                           dtype=dtype,
                                           bond_pairs="edge_reverse" in potential.model.batch_index)
                batch = device_batch(potential, host)
                vel_pad = np.zeros((batch.num_nodes, 3))
                vel_cat = np.concatenate(velocities, axis=0)
                vel_pad[: len(vel_cat)] = vel_cat
                vel0, masses = (torch.as_tensor(a, dtype=param.dtype, device=param.device)
                                for a in (vel_pad, node_masses(host)))
            pos, vel, lat, logs = _md_inner(potential, batch, vel0, masses, gen, config, n_steps)
            pos, vel, lat = (t.cpu().double().numpy() for t in (pos, vel, lat))
            logs_all.append([t.cpu().double().numpy() for t in logs])
            off = 0
            for i, g in enumerate(graphs):
                n = g.num_nodes
                positions[i] = pos[off:off + n]
                velocities[i] = vel[off:off + n]
                lattices[i] = lat[i]
                off += n

    energies, kinetic, _, pressures, volumes = (
        np.concatenate([chunk[k] for chunk in logs_all], axis=0) for k in range(5))
    energies, kinetic = energies[:, :nsys], kinetic[:, :nsys]
    # NVE conserves total momentum (drift-removed init), so 3 COM dof are
    # frozen: dof = 3N - 3. Langevin kicks break momentum conservation -> 3N.
    com_dof = 3.0 if config.ensemble == "nve" else 0.0
    dof = np.array([max(3.0 * len(s) - com_dof, 3.0) for s in structures])
    temperatures = 2.0 * kinetic / (dof * KB)
    final = [
        Structure(lat, p, s.atomic_numbers, {**s.properties, "velocities": v})
        for s, p, v, lat in zip(structures, positions, velocities, lattices)
    ]
    trajectories = None
    if config.record_trajectory:
        # chunks may have different node padding; slice each structure's block
        offs = np.cumsum([0] + [len(s) for s in structures])
        trajectories = [
            np.concatenate([chunk[2][:, offs[i]:offs[i + 1]] for chunk in logs_all], axis=0)
            for i in range(nsys)
        ]
    npt = config.ensemble == "npt"
    return MDResult(
        structures=final,
        energies=energies,
        kinetic=kinetic,
        temperatures=temperatures,
        times=np.arange(1, config.n_steps + 1) * config.dt,
        trajectories=trajectories,
        pressures=pressures[:, :nsys] if npt else None,
        volumes=volumes[:, :nsys] if npt else None,
    )

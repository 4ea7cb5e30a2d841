"""Batched structure relaxation (FIRE / L-BFGS) driven by the potential.

Counterpart of ``torch_m3gnet_tpu.simulate.relax``:

- **FIRE** (Bitzek et al., PRL 97, 170201 (2006));
- **L-BFGS** (two-loop recursion, fixed history, trust-radius step: ASE's
  line-search-free variant).

Both advance every structure of one padded batch in lockstep. The host
rebuilds the neighbour list with ``cutoff + skin`` every ``rebuild_every``
steps (verlet skin) and :func:`~torch_m3gnet_tpu_torch.data.to_torch`
moves the batch, with the kernels' per-batch index, to the potential's
device once per rebuild. Between rebuilds the steps are a Python loop of
device operations with no host synchronisation: the optimiser state lives
in device tensors, each step's forces come from one call of the potential
on ``batch.replace(positions=pos, lattice=lat)`` (which keeps the batch's
index), and its outputs are detached so that no autograd graph reaches the
next step. The host reads the state back once per rebuild.

With ``relax_cell=True`` the cell is a per-graph strain degree of freedom
(ASE UnitCellFilter scheme: generalized coordinates = atomic positions +
cell_factor x strain, generalized force on the strain = -V sigma /
cell_factor, cell_factor = atoms per graph), so cell and positions relax
jointly inside the loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from torch_m3gnet_tpu_torch.data.graph import (
    GraphBatch,
    batch_graphs,
    graph_from_structure,
    pad_batch,
    round_up,
    to_torch,
)
from torch_m3gnet_tpu_torch.data.structure import Structure
from torch_m3gnet_tpu_torch.ops.segment import segment_sum
from torch_m3gnet_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class FireConfig:
    dt_start: float = 0.1
    dt_max: float = 1.0
    n_min: int = 5
    f_inc: float = 1.1
    f_dec: float = 0.5
    alpha_start: float = 0.1
    f_alpha: float = 0.99
    max_steps: int = 200
    rebuild_every: int = 20
    fmax: float = 0.05  # eV/A convergence threshold (max force component norm)
    relax_cell: bool = False
    smax: float = 5e-3  # eV/A^3 stress convergence threshold (relax_cell)
    max_strain_step: float = 0.02  # per-step strain cap (topology skin safety)


@dataclass(frozen=True)
class LbfgsConfig:
    history: int = 8
    alpha: float = 70.0  # initial inverse Hessian H0 = 1/alpha (ASE default)
    maxstep: float = 0.2  # A trust radius per step (max atom displacement)
    max_steps: int = 200
    rebuild_every: int = 20
    fmax: float = 0.05
    relax_cell: bool = False
    smax: float = 5e-3
    max_strain_step: float = 0.02


def build_batch(structures: Sequence[Structure], positions, lattices, cutoff: float,
                threebody_cutoff: float, pad_multiple: int, dtype=np.float64,
                bond_pairs: bool = False):
    """The host graphs of ``structures`` at ``positions`` and ``lattices``
    (neighbour list at ``cutoff``, which the callers widen by their skin)
    and their padded batch: one rebuild's host work, in the spans
    ``m3gnet.build_batch.graphs`` and ``m3gnet.build_batch.pad``
    (``bond_pairs``: the edges' reverses, for a model that reads them)."""
    with span("m3gnet.build_batch.graphs"):
        graphs = [
            graph_from_structure(Structure(lat, p, s.atomic_numbers), cutoff, threebody_cutoff,
                                 dtype=dtype, bond_pairs=bond_pairs)
            for s, p, lat in zip(structures, positions, lattices)
        ]
    with span("m3gnet.build_batch.pad"):
        cat = batch_graphs(graphs)
        return graphs, pad_batch(
            cat,
            round_up(cat.num_nodes + 1, pad_multiple),
            round_up(cat.num_edges + 1, pad_multiple),
            round_up(cat.num_triplets + 1, pad_multiple),
            cat.num_graphs,
        )


def device_batch(potential, batch: GraphBatch) -> GraphBatch:
    """``batch`` on the potential's device and dtype, with the kernel index
    its three-body mode reads."""
    param = next(potential.parameters())
    return to_torch(batch, param.device, param.dtype, potential.model.batch_index)


def forces_stress(potential, batch: GraphBatch, pos, lat):
    """(forces, energy, stress) at ``pos`` and ``lat``, detached."""
    out = potential(batch.replace(positions=pos, lattice=lat))
    return out.forces.detach(), out.energy.detach(), out.stress.detach()


def _stress_force(stress_v, lat, n_node, dtype):
    """Generalized force on the strain DOF: -V sigma / cell_factor (B, 3, 3),
    with cell_factor = atoms per graph (ASE UnitCellFilter default), which
    puts the strain coordinates on the scale of atomic displacements."""
    sv = stress_v
    sig = torch.stack([
        torch.stack([sv[:, 0], sv[:, 5], sv[:, 4]], dim=-1),
        torch.stack([sv[:, 5], sv[:, 1], sv[:, 3]], dim=-1),
        torch.stack([sv[:, 4], sv[:, 3], sv[:, 2]], dim=-1),
    ], dim=-2)
    vol = torch.abs((lat[:, 0] * torch.linalg.cross(lat[:, 1], lat[:, 2])).sum(-1))
    cf = torch.clamp(n_node.to(dtype), min=1.0)
    return -sig * (vol / cf)[:, None, None]


def _apply_strain(pos, lat, deps, node_graph, max_strain):
    """Apply per-graph strain increments to lattice and positions jointly.

    ``deps`` (B, 3, 3) is capped at ``max_strain`` per component so that the
    fixed topology stays valid between rebuilds. Returns the deformed
    positions and lattices and the strain actually applied.
    """
    cap = deps.abs().amax(dim=(-1, -2), keepdim=True)
    deps = deps * torch.clamp(max_strain / torch.clamp(cap, min=1e-20), max=1.0)
    d = torch.eye(3, dtype=pos.dtype, device=pos.device) + deps  # (B, 3, 3)
    lat = torch.einsum("bij,bkj->bik", lat, d)  # rows a_i <- a_i @ D.T
    dn = d.index_select(0, node_graph)  # (N, 3, 3)
    pos = torch.einsum("nj,nkj->nk", pos, dn)
    return pos, lat, deps


def _fire_inner(potential, batch: GraphBatch, cfg: FireConfig, n_steps: int):
    """``n_steps`` FIRE steps over the fixed topology of ``batch`` (on the
    device); returns (pos, lat, forces, energy, stress) at the end.

    With ``cfg.relax_cell`` the per-graph strain is a FIRE DOF: its
    velocities and forces follow the atoms' mixing and time-step rules, and
    each step's strain increment deforms positions and lattice together.
    """
    pos = batch.positions
    dtype = pos.dtype
    nmask = batch.node_mask.to(dtype)[:, None]
    node_graph, n_node, nb = batch.node_graph.long(), batch.n_node, batch.num_graphs
    lat = batch.lattice.to(dtype)
    vel = torch.zeros_like(pos)
    vel_c = pos.new_zeros((nb, 3, 3))
    dt = pos.new_full((nb,), cfg.dt_start)
    alpha = pos.new_full((nb,), cfg.alpha_start)
    n_pos = torch.zeros(nb, dtype=torch.int32, device=pos.device)
    cf = torch.clamp(n_node.to(dtype), min=1.0)[:, None, None]

    for _ in range(n_steps):
        f, _, sv = forces_stress(potential, batch, pos, lat)
        g_c = _stress_force(sv, lat, n_node, dtype) if cfg.relax_cell else None

        # per-graph power and norms over the combined (atomic + strain) DOF
        p = segment_sum((f * vel).sum(-1), node_graph, nb)
        f2 = segment_sum((f * f).sum(-1), node_graph, nb)
        v2 = segment_sum((vel * vel).sum(-1), node_graph, nb)
        if cfg.relax_cell:
            p = p + (g_c * vel_c).sum((-1, -2))
            f2 = f2 + (g_c * g_c).sum((-1, -2))
            v2 = v2 + (vel_c * vel_c).sum((-1, -2))
        ratio = torch.sqrt(v2 + 1e-20) / torch.sqrt(f2 + 1e-20)
        uphill = p <= 0.0  # (B,)

        a_g = alpha[node_graph][:, None]
        mix = (1.0 - a_g) * vel + a_g * ratio[node_graph][:, None] * f
        vel = torch.where(uphill[node_graph][:, None], torch.zeros_like(mix), mix)
        if cfg.relax_cell:
            a_b = alpha[:, None, None]
            mix_c = (1.0 - a_b) * vel_c + a_b * ratio[:, None, None] * g_c
            vel_c = torch.where(uphill[:, None, None], torch.zeros_like(mix_c), mix_c)

        n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
        grow = (~uphill) & (n_pos > cfg.n_min)
        dt = torch.where(grow, torch.clamp(dt * cfg.f_inc, max=cfg.dt_max), dt)
        alpha = torch.where(grow, alpha * cfg.f_alpha, alpha)
        dt = torch.where(uphill, dt * cfg.f_dec, dt)
        alpha = torch.where(uphill, torch.full_like(alpha, cfg.alpha_start), alpha)

        vel = vel + dt[node_graph][:, None] * f
        pos = pos + dt[node_graph][:, None] * vel * nmask
        if cfg.relax_cell:
            vel_c = vel_c + dt[:, None, None] * g_c
            deps = dt[:, None, None] * vel_c / cf
            pos, lat, _ = _apply_strain(pos, lat, deps, node_graph, cfg.max_strain_step)
    f, e, sv = forces_stress(potential, batch, pos, lat)
    return pos, lat, f, e, sv


def _two_loop(g, g_c, hist, count: int, m: int, gdot, node_graph, alpha0: float):
    """The L-BFGS two-loop recursion: z = H g for the inverse Hessian H that
    the stored curvature pairs define (per graph), with H0 = gamma I, gamma
    = s.y / y.y of the newest pair (1 / alpha0 before the first). The pairs
    are the ``count`` newest of the ring buffers in ``hist`` (s, y, s_c,
    y_c, rho); ``count`` is known on the host, so only stored pairs are
    visited."""
    s_hist, y_hist, sc_hist, yc_hist, rho = hist
    slots = [(count - 1 - j) % m for j in range(min(count, m))]  # newest first
    q, q_c, alphas = g, g_c, {}
    for i in slots:
        a = rho[:, i] * gdot(s_hist[i], sc_hist[i], q, q_c)
        alphas[i] = a
        q = q - a[node_graph][:, None] * y_hist[i]
        q_c = q_c - a[:, None, None] * yc_hist[i]
    if count:
        last = slots[0]
        sy = gdot(s_hist[last], sc_hist[last], y_hist[last], yc_hist[last])
        yy = gdot(y_hist[last], yc_hist[last], y_hist[last], yc_hist[last])
        gamma = sy / torch.clamp(yy, min=1e-20)
    else:
        gamma = g.new_full((rho.shape[0],), 1.0 / alpha0)
    z = gamma[node_graph][:, None] * q
    z_c = gamma[:, None, None] * q_c
    for i in reversed(slots):
        corr = alphas[i] - rho[:, i] * gdot(y_hist[i], yc_hist[i], z, z_c)
        z = z + corr[node_graph][:, None] * s_hist[i]
        z_c = z_c + corr[:, None, None] * sc_hist[i]
    return z, z_c


def _lbfgs_inner(potential, batch: GraphBatch, cfg: LbfgsConfig, n_steps: int):
    """``n_steps`` batched L-BFGS steps (two-loop recursion, trust-radius
    step, no line search) over the fixed topology of ``batch``.

    Per-graph curvature pairs live in (m, ...) ring buffers on the device;
    every inner product is a per-graph sum, so each crystal runs its own
    optimiser. The step is clipped to ``maxstep`` per atom, and with
    relax_cell to ``max_strain_step`` per strain component.
    """
    pos = batch.positions
    dtype = pos.dtype
    nmask = batch.node_mask.to(dtype)[:, None]
    node_graph, n_node, nb, m = batch.node_graph.long(), batch.n_node, batch.num_graphs, cfg.history
    lat = batch.lattice.to(dtype)
    cf = torch.clamp(n_node.to(dtype), min=1.0)[:, None, None]

    def gdot(a_pos, a_c, b_pos, b_c):
        """Per-graph inner product over the combined DOF -> (B,)."""
        d = segment_sum((a_pos * b_pos).sum(-1), node_graph, nb)
        if cfg.relax_cell:
            d = d + (a_c * b_c).sum((-1, -2))
        return d

    def grad_of(pos, lat):
        """Generalized gradient (negative forces) of the combined DOF."""
        f, _, sv = forces_stress(potential, batch, pos, lat)
        g_c = (_stress_force(sv, lat, n_node, dtype) if cfg.relax_cell
               else pos.new_zeros((nb, 3, 3)))
        return -(f * nmask), -g_c

    g, g_c = grad_of(pos, lat)
    hist = (pos.new_zeros((m,) + pos.shape), pos.new_zeros((m,) + pos.shape),
            pos.new_zeros((m, nb, 3, 3)), pos.new_zeros((m, nb, 3, 3)), pos.new_zeros((nb, m)))
    for count in range(n_steps):
        z, z_c = _two_loop(g, g_c, hist, count, m, gdot, node_graph, cfg.alpha)

        # step = -z, trust-radius clipped per graph
        step = -z * nmask
        sq = (step * step).sum(-1)
        longest_sq = sq.new_zeros(nb).scatter_reduce(0, node_graph, sq, "amax", include_self=False)
        longest = torch.sqrt(longest_sq + 1e-20)
        scale = torch.clamp(cfg.maxstep / torch.clamp(longest, min=1e-20), max=1.0)
        pos_new = pos + scale[node_graph][:, None] * step
        lat_new, deps = lat, torch.zeros_like(z_c)
        if cfg.relax_cell:
            deps = -scale[:, None, None] * z_c / cf
            pos_new, lat_new, deps = _apply_strain(pos_new, lat, deps, node_graph,
                                                   cfg.max_strain_step)

        g_new, gc_new = grad_of(pos_new, lat_new)
        s_k, y_k = pos_new - pos, g_new - g
        # the strain pair uses the strain actually applied (after the cap)
        sc_k, yc_k = deps * cf, gc_new - g_c
        sy_k = gdot(s_k, sc_k, y_k, yc_k)
        slot = count % m
        for buf, val in zip(hist[:4], (s_k, y_k, sc_k, yc_k)):
            buf[slot] = val
        hist[4][:, slot] = torch.where(sy_k > 1e-12, 1.0 / torch.clamp(sy_k, min=1e-20),
                                       torch.zeros_like(sy_k))
        pos, lat, g, g_c = pos_new, lat_new, g_new, gc_new
    f, e, sv = forces_stress(potential, batch, pos, lat)
    return pos, lat, f, e, sv


def relax_structures(
    potential,
    structures: Sequence[Structure],
    cutoff: float,
    threebody_cutoff: float,
    config: FireConfig | LbfgsConfig = FireConfig(),
    skin: float = 0.3,
    pad_multiple: int = 128,
) -> tuple[list[Structure], np.ndarray, np.ndarray]:
    """Relax a batch of structures (FIRE or L-BFGS by config type) with the
    port's ``M3GNetPotential``, on its device and in its dtype.

    The neighbour list is built with ``cutoff + skin``, so the topology stays
    valid while atoms move up to ``skin / 2``; the host rebuilds it every
    ``rebuild_every`` steps and stops early once every structure has
    ``fmax`` (and with ``relax_cell``, ``|sigma|_max <= smax``).

    Returns:
        (relaxed structures, final energies (B,), final max-force (B,)).
    """
    structures = [s.wrap() for s in structures]
    inner = _lbfgs_inner if isinstance(config, LbfgsConfig) else _fire_inner
    n_outer = math.ceil(config.max_steps / config.rebuild_every)
    positions = [s.cart_coords.copy() for s in structures]
    lattices = [s.lattice.copy() for s in structures]
    nsys = len(structures)
    energies = np.zeros(nsys)
    fmax = np.full(nsys, np.inf)

    with torch.no_grad():
        for _ in range(n_outer):
            graphs, host = build_batch(structures, positions, lattices, cutoff + skin,
                                       threebody_cutoff, pad_multiple,
                                       bond_pairs="edge_reverse" in potential.model.batch_index)
            batch = device_batch(potential, host)
            pos, lat, forces, energy, stress = (
                t.cpu().double().numpy() for t in inner(potential, batch, config,
                                                        config.rebuild_every))
            energies = energy[:nsys]
            smax_seen = np.abs(stress[:nsys]).max(axis=1)
            off = 0
            for i, g in enumerate(graphs):
                n = g.num_nodes
                positions[i] = pos[off:off + n]
                fmax[i] = float(np.linalg.norm(forces[off:off + n], axis=1).max())
                if config.relax_cell:
                    lattices[i] = lat[i]
                off += n
            converged = (fmax <= config.fmax).all()
            if config.relax_cell:
                converged = converged and (smax_seen <= config.smax).all()
            if converged:
                break

    relaxed = [
        Structure(lat, p, s.atomic_numbers, dict(s.properties))
        for s, p, lat in zip(structures, positions, lattices)
    ]
    return relaxed, energies, fmax

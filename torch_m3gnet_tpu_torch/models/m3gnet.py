"""The M3GNet potential in PyTorch, feature-major.

Counterpart of ``torch_m3gnet_tpu.models.m3gnet``. Every E/N/T-scale
activation is (features, entities). The three-body stage runs in one of the
JAX package's three modes, which compute the same function:

- ``"factorized"`` (``_forward_fm`` there): per-edge factors only, nothing
  at triplet scale, through ``ops.factorized_stage``;
- ``"fused"`` (``_forward_em`` with ``fused_triplets``): the per-triplet
  basis, with the triplet geometry read through ``ops.windowed_take`` and
  the gate gathered and summed back to edges by ``ops.fused_triplet``;
- ``"gather"`` (``_forward_em``): the same per-triplet stage through plain
  index ops (``index_select``/``index_add``), as JAX runs it through XLA's.

The kernel ops run their hand-written CUDA kernels on a CUDA device and
their plain versions on the CPU. The sums over sorted ids run through
``ops.sorted_segment``: the node aggregation by ``edge_src``, the gather-mode
triplet->edge sum by ``triplet_e1``, the forces by ``edge_src`` and the
strain stress by ``edge_graph``. While a torch profiler records, the
stage's set-up and each block's aggregation run inside ``m3gnet.threebody``
spans (``utils.profiling``): 1 + ``num_blocks`` a forward.

- :func:`edge_vectors_fm` builds the (3, E) pair vectors from positions,
  cell shifts and lattices;
- :class:`M3GNet` maps a batch and those vectors to per-graph energies;
- :class:`M3GNetPotential` takes ONE backward pass with respect to the edge
  vectors, from which forces and stress are assembled (``create_graph=True``
  keeps its graph, so a loss on forces and stress differentiates to the
  weights);
- :func:`build_model` assembles a potential from a config on a device.

Two settings of the JAX model carry over with its semantics:

- ``compute_dtype`` (``"bfloat16"``): rounding at fixed points, f32 (the
  geometry dtype) arithmetic everywhere else. The atom embedding, the
  radial basis and the three-body stage's per-edge factors are rounded to
  it; every dense layer promotes its input to the weights' dtype, so no
  matmul runs in it; the kernels take their operands in the geometry
  dtype, cast before their Functions, so the cast's backward rounds their
  cotangents as JAX's convert VJP does; readout, energies, forces and
  stress stay in the geometry dtype.
- ``remat_triplets``: each block's three-body stage (the closure that maps
  the gate to the stage's output) runs under ``torch.utils.checkpoint``
  (non-reentrant), which keeps none of its intermediates and recomputes it
  in every backward pass that reaches it: once in an evaluation, twice in
  a train step (the force loss differentiates the recomputed stage again).
  On a shard of a partitioned graph the recompute reruns the stage's halo
  exchange, in the same order on every rank.

Graph parallelism (``parallel.graph_shard``) runs this same module on each
shard of one partitioned graph, with ``group`` the process group of the
shards: every read of node rows through a destination id (positions for
the edge vectors, ``vj``, the gate gather of each mode) goes through
``ops.halo.extend_nodes_fm``, which appends the rows that other shards own
(the halo exchange, or the all-gather of a partition without a halo plan).
Sums by ``edge_src`` stay local, as every edge belongs to its source's
shard. The potential sums the forces' destination side into those extended
rows and sends them home (``ops.halo.reduce_extended_fm``), and all-reduces
the energy and the virial over the group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from torch_m3gnet_tpu_torch.data.graph import GraphBatch, to_torch
from torch_m3gnet_tpu_torch.models.layers import DenseFM, Embed, GatedMLPFM
from torch_m3gnet_tpu_torch.ops.basis import (
    chi_norm_constants,
    cutoff_poly,
    legendre_cos_all,
    normalized_spherical_bessel,
    real_racah_harmonics_fm,
    smooth_radial_basis_fm,
    spherical_bessel_zeros,
)
from torch_m3gnet_tpu_torch.ops.factorized_stage import q_scatter, r1_gather
from torch_m3gnet_tpu_torch.ops.fused_triplet import fused_triplet_gate_sum, triplet_e2_order
from torch_m3gnet_tpu_torch.ops.halo import (
    all_reduce,
    extend_nodes_fm,
    extended_nodes,
    reduce_extended_fm,
)
from torch_m3gnet_tpu_torch.ops.segment import segment_sum, segment_sum_fm, take_fm
from torch_m3gnet_tpu_torch.ops.sorted_segment import sorted_segment_offsets, sorted_segment_sum_fm
from torch_m3gnet_tpu_torch.ops.windowed_take import windowed_take_fm
from torch_m3gnet_tpu_torch.utils.profiling import span

THREEBODY_MODES = ("factorized", "fused", "gather")
PALLAS_SEGMENT = ("auto", "on", "off")


@dataclass(frozen=True)
class PotentialOutput:
    """Energies/forces/stresses for a batch (padded entries zeroed)."""

    energy: torch.Tensor  # (B,) total energy, eV
    forces: torch.Tensor  # (N, 3) eV/Angstrom
    stress: torch.Tensor  # (B, 6) Voigt [xx, yy, zz, yz, zx, xy], eV/A^3
    energy_per_atom: torch.Tensor  # (B,) eV/atom
    atomic_energy: torch.Tensor  # (N,) eV


def take_dst_fm(x_fm: torch.Tensor, graph: GraphBatch, idx: torch.Tensor,
                group=None) -> torch.Tensor:
    """``x_fm`` (F, N) read at the destination ids ``idx`` (columns); on a
    shard of a partitioned graph (``group`` given) through the columns
    extended with those that other shards own."""
    if group is not None:
        x_fm = extend_nodes_fm(x_fm, graph, group)
    return take_fm(x_fm, idx)


def edge_vectors_fm(graph: GraphBatch, positions: torch.Tensor,
                    lattice: torch.Tensor, group=None) -> torch.Tensor:
    """(3, E) pair vectors r_e = pos[dst] + shift @ lattice[graph] - pos[src]
    (``group``: see :func:`take_dst_fm`)."""
    pos_fm = positions.t()  # (3, N)
    edge_graph = graph.node_graph.index_select(0, graph.edge_src)  # (E,)
    lat_e = take_fm(lattice.reshape(-1, 9).t(), edge_graph)  # (9, E): rows lattice[p, q]
    shift_fm = graph.edge_cell_shift.to(positions.dtype).t()  # (3, E)
    shift_vec = torch.stack(
        [sum(shift_fm[p] * lat_e[3 * p + q] for p in range(3)) for q in range(3)]
    )
    return (take_dst_fm(pos_fm, graph, graph.edge_dst, group) + shift_vec
            - take_fm(pos_fm, graph.edge_src))


class M3GNet(nn.Module):
    """Energy model: batch + (3, E) edge vectors -> per-graph total energy.

    Parameters carry the Flax names of the JAX model (``atom_embed``,
    ``edge_init``, ``three_gate_{b}``, ``three_mlp_{b}``, ``conv_edge_{b}``,
    ``conv_edge_w_{b}``, ``conv_node_{b}``, ``conv_node_w_{b}``,
    ``readout``) in the Flax orientation, so ``models.convert`` maps a Flax
    tree onto ``state_dict`` keys by name alone.
    """

    def __init__(
        self,
        cutoff: float = 5.0,
        threebody_cutoff: float = 4.0,
        l_max: int = 3,
        n_max: int = 3,
        num_types: int = 95,
        embedding_dim: int = 64,
        num_blocks: int = 3,
        elemental_energies: Sequence[float] = (),
        energy_scale: float = 1.0,
        length_scale: float = 1.0,
        threebody_mode: str = "factorized",
        compute_dtype: torch.dtype | None = None,
        remat_triplets: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if threebody_mode not in THREEBODY_MODES:
            raise ValueError(f"unknown threebody_mode: {threebody_mode}")
        self.threebody_mode = threebody_mode
        # None: compute in the geometry dtype (the weights' dtype).
        self.compute_dtype = compute_dtype
        self.remat_triplets = remat_triplets
        self.cutoff = cutoff
        self.threebody_cutoff = threebody_cutoff
        self.l_max = l_max
        self.n_max = n_max
        self.num_blocks = num_blocks
        self.energy_scale = energy_scale
        self.length_scale = length_scale
        d, ln = embedding_dim, l_max * n_max
        gen = generator

        self.atom_embed = Embed(num_types, d, gen)
        self.edge_init = DenseFM(n_max, d, use_bias=False, generator=gen)
        for b in range(num_blocks):
            self.add_module(f"three_gate_{b}", DenseFM(d, ln, generator=gen))
            self.add_module(f"three_mlp_{b}", GatedMLPFM(ln, [d], use_bias=False, generator=gen))
            self.add_module(f"conv_edge_{b}", GatedMLPFM(3 * d, [d, d], generator=gen))
            self.add_module(f"conv_edge_w_{b}", DenseFM(n_max, d, use_bias=False, generator=gen))
            self.add_module(f"conv_node_{b}", GatedMLPFM(3 * d, [d, d], generator=gen))
            self.add_module(f"conv_node_w_{b}", DenseFM(n_max, d, use_bias=False, generator=gen))
        self.readout = GatedMLPFM(d, [d, d, 1], is_output=True, generator=gen)

        elem = np.zeros(num_types) if len(elemental_energies) == 0 else np.asarray(
            elemental_energies, dtype=np.float64
        )
        # A fixed input of the model, not a weight (the Flax tree lacks it):
        # float64, cast at use, so the energies keep their digits at any dtype.
        self.register_buffer(
            "elemental_energies", torch.as_tensor(elem, dtype=torch.float64), persistent=False
        )
        self.sph_norm = [math.sqrt((2 * ell + 1) / (4.0 * math.pi)) for ell in range(l_max)]
        # The same on the model's device for the per-triplet stage, so that
        # no call copies it from the host (a synchronising copy).
        self.register_buffer("sph_norm_t", torch.tensor(self.sph_norm, dtype=torch.float64),
                             persistent=False)
        # The radial basis' (roots, norms), likewise (a cache filled inside
        # a torch.func transform, a committee or a Hessian, would keep
        # tensors of that transform's level).
        chi = (spherical_bessel_zeros(l_max + 1, n_max)[:l_max],
               chi_norm_constants(cutoff / length_scale, l_max, n_max))
        self.register_buffer("chi_constants", torch.as_tensor(np.stack(chi)), persistent=False)

    @property
    def batch_index(self) -> tuple[str, ...]:
        """The parts of the per-batch kernel index (``data.to_torch``) that
        this mode reads: the ``edge_src`` offsets in every mode (the node
        aggregation and the forces), the ``triplet_e1`` offsets in the
        gather and fused modes, the e2 order in the fused mode."""
        extra = {"gather": ("triplet_e1_offsets",),
                 "fused": ("triplet_e1_offsets", "triplet_e2_order", "triplet_e2_offsets")}
        return ("edge_src_offsets",) + extra.get(self.threebody_mode, ())

    def forward(self, graph: GraphBatch, r_vec_fm: torch.Tensor, group=None,
                remat: bool | None = None):
        """Returns (per-graph energy (B,), per-atom energy (N,)), both in eV.
        On a shard of a partitioned graph (``group`` given) both are the
        shard's own share: the energy of its nodes. ``remat`` (default
        ``remat_triplets``) runs each block's three-body stage under the
        checkpoint; ``torch.func`` transforms refuse its saved-tensor
        hooks, so the functional path passes False (remat changes no
        value)."""
        dtype = r_vec_fm.dtype
        cdtype = self.compute_dtype or dtype
        n_max = self.n_max
        rc = self.cutoff / self.length_scale
        num_nodes = graph.num_nodes
        src, dst = graph.edge_src, graph.edge_dst
        node_mask = graph.node_mask.to(dtype)
        edge_mask = graph.edge_mask.to(dtype)

        # --- geometry. Grad-safe masked norm: padded edges get distance rc
        # (not 0); the inner where keeps sqrt's gradient finite there.
        r_fm = r_vec_fm / self.length_scale
        sq = (r_fm * r_fm).sum(0)
        sq_safe = torch.where(graph.edge_mask, sq, torch.ones_like(sq))
        dist = torch.where(graph.edge_mask, torch.sqrt(sq_safe), torch.full_like(sq, rc))

        # --- featurization (in the compute dtype; each dense layer promotes)
        v_fm = self.atom_embed(graph.atom_types, cdtype).t()  # (D, N)
        ew_fm = smooth_radial_basis_fm(dist, n_max, rc).to(cdtype)  # (n, E)
        e_fm = F.silu(self.edge_init(ew_fm))  # (D, E)

        with span("m3gnet.threebody"):
            if self.threebody_mode == "factorized":
                triplet_aggregate = self._factorized_stage(graph, r_fm, dist, cdtype, group)
            else:
                triplet_aggregate = self._triplet_stage(graph, r_fm, dist, cdtype, group)
        if self.remat_triplets if remat is None else remat:
            stage = triplet_aggregate

            def triplet_aggregate(gate_fm):
                return checkpoint(stage, gate_fm, use_reentrant=False,
                                  preserve_rng_state=False)

        # --- interaction blocks
        for b in range(self.num_blocks):
            gate_fm = torch.sigmoid(getattr(self, f"three_gate_{b}")(v_fm))  # (ln, N)
            with span("m3gnet.threebody"):
                aggregated = triplet_aggregate(gate_fm)
            e_fm = e_fm + getattr(self, f"three_mlp_{b}")(aggregated)

            vi = take_fm(v_fm, src)
            vj = take_dst_fm(v_fm, graph, dst, group)
            concat = torch.cat([vi, vj, e_fm], 0)  # (3D, E)
            e_fm = e_fm + getattr(self, f"conv_edge_{b}")(concat) * getattr(
                self, f"conv_edge_w_{b}"
            )(ew_fm)
            concat = torch.cat([vi, vj, e_fm], 0)
            node_msg = getattr(self, f"conv_node_{b}")(concat) * getattr(
                self, f"conv_node_w_{b}"
            )(ew_fm)
            v_fm = v_fm + sorted_segment_sum_fm(node_msg * edge_mask, src, num_nodes,
                                                graph.edge_src_offsets)

        # --- readout, in the geometry dtype
        atomic = self.readout(v_fm)[0].to(dtype)  # (N,)
        elem = self.elemental_energies.to(dtype).index_select(0, graph.atom_types)
        scaled_atomic = (elem / self.energy_scale + atomic) * node_mask
        scaled_total = segment_sum(scaled_atomic, graph.node_graph, graph.num_graphs)
        total = self.energy_scale * scaled_total * graph.graph_mask.to(dtype)
        return total, self.energy_scale * scaled_atomic

    def _factorized_stage(self, graph: GraphBatch, r_fm, dist, cdtype, group=None):
        """The factorized three-body stage: gate (LN, N) -> (LN, E), from
        per-edge factors only (the j = k diagonal that the triplet
        enumeration excludes is subtracted analytically, P_l(1) = 1).

        Rounding points of JAX's fused-kernel path (``_forward_fm``): the
        per-edge factors and the gathered gate in ``cdtype``, their
        product ``g`` formed there; Q and R1 take ``sh`` and ``g`` in the
        geometry dtype and sum in it."""
        dtype = r_fm.dtype
        l_max, n_max = self.l_max, self.n_max
        ln, num_edges = l_max * n_max, graph.num_edges
        rc = self.cutoff / self.length_scale
        rc3 = self.threebody_cutoff / self.length_scale
        src, dst = graph.edge_src, graph.edge_dst
        u_fm = r_fm / dist[None, :]  # padded edges: dist = rc > 0
        sh_fm = real_racah_harmonics_fm(u_fm, l_max)  # (M, E)
        chi_fm = normalized_spherical_bessel(dist, rc, l_max, n_max,
                                             self.chi_constants)  # (l, n, E)
        fc_e = cutoff_poly(dist, rc3) * graph.edge_mask.to(dist.dtype)  # zero on padded edges
        chifc = (chi_fm * fc_e).reshape(ln, num_edges).to(cdtype)
        fcn = torch.stack([c * fc_e for c in self.sph_norm])  # (l, E)
        fcn = fcn[:, None, :].expand(l_max, n_max, num_edges).reshape(ln, num_edges).to(cdtype)
        sh_fm = sh_fm.to(cdtype)

        def triplet_aggregate(gate_fm):
            # A padded edge has gm = 0 (fc_e carries the edge mask), so it
            # adds nothing to A and its own output is scaled by fcn = 0.
            g = chifc * take_dst_fm(gate_fm, graph, dst, group).to(cdtype)  # (ln, E)
            # One cast per kernel operand, as each JAX wrapper casts its own.
            a = q_scatter(sh_fm.to(dtype), g.to(dtype), src, graph.num_nodes,
                          l_max, n_max)  # (M*n, N)
            proj = r1_gather(a, sh_fm.to(dtype), src, l_max, n_max)  # (ln, E)
            return fcn * (proj.to(cdtype) - g)

        return triplet_aggregate

    def _triplet_stage(self, graph: GraphBatch, r_fm, dist, cdtype, group=None):
        """The per-triplet three-body stage (fused or gather): gate (LN, N)
        -> (LN, E) with out[:, e] = sum_{t: e1[t]=e} basis[:, t] *
        gate[:, k(t)], basis (LN, T) = chi_ln(r_ik) c_l P_l(cos jik)
        fc(r_ij) fc(r_ik), zeroed on padded triplets.

        Rounding points of JAX's ``_forward_em``: the basis is rounded to
        ``cdtype``; the gate and the sum stay in the geometry dtype (the
        fused kernel takes both in it; in gather mode the product
        promotes); the fused mode rounds its output to ``cdtype``."""
        l_max, n_max = self.l_max, self.n_max
        num_edges = graph.num_edges
        rc = self.cutoff / self.length_scale
        rc3 = self.threebody_cutoff / self.length_scale
        e1, e2, dst = graph.triplet_e1, graph.triplet_e2, graph.edge_dst
        fused = self.threebody_mode == "fused"

        # T-scale geometry from the packed [x, y, z, |r|] rows of each edge.
        geom_fm = torch.cat([r_fm, dist[None, :]], 0)  # (4, E)
        if fused:
            # The batch's owners of e1 (its offsets; e1 is sorted) and of e2
            # (the e2 order), built here for a batch that lacks them: the
            # takes' VJPs sum along them, and so does the backward kernel's
            # sum by e2.
            e1_offsets = graph.triplet_e1_offsets
            if e1_offsets is None:
                e1_offsets = sorted_segment_offsets(e1, num_edges)
            e2_order = (graph.triplet_e2_order, graph.triplet_e2_offsets)
            if e2_order[0] is None or e2_order[1] is None:
                e2_order = triplet_e2_order(e2, num_edges)
            g1 = windowed_take_fm(geom_fm, e1, (None, e1_offsets))  # (4, T)
            g2 = windowed_take_fm(geom_fm, e2, e2_order)
        else:
            g1, g2 = take_fm(geom_fm, e1), take_fm(geom_fm, e2)
        rij, rik = g1[3], g2[3]  # padded triplets: rij = rc > 0 (e1 is a padded edge)
        cos_jik = torch.clamp((g1[:3] * g2[:3]).sum(0) / (rij * rik), -1.0, 1.0)
        fc = cutoff_poly(rij, rc3) * cutoff_poly(rik, rc3)  # (T,)
        sph = legendre_cos_all(cos_jik, l_max) * self.sph_norm_t[:, None].to(cos_jik.dtype)
        chi = normalized_spherical_bessel(rik, rc, l_max, n_max, self.chi_constants)  # (l, n, T)
        # The mask stays: padded triplets point at real edges (e2 = 0), and
        # it is what zeroes their gradient.
        basis_fm = (chi * sph[:, None, :] * fc).reshape(l_max * n_max, -1)
        basis_fm = basis_fm * graph.triplet_mask.to(basis_fm.dtype)
        basis_c = basis_fm.to(cdtype)

        if fused:
            # gate pre-gathered node -> edge (E-scale); the kernel's T-scale
            # reads of it by e2 are then window-local. The e2 order goes with
            # it, for the backward kernel's sum by e2.
            return lambda gate_fm: fused_triplet_gate_sum(
                basis_c.to(r_fm.dtype), take_dst_fm(gate_fm, graph, dst, group), e1, e2,
                num_edges, e2_order
            ).to(cdtype)
        node_k = graph.triplet_node_k
        if node_k is None:
            node_k = dst.index_select(0, e2)
        return lambda gate_fm: sorted_segment_sum_fm(
            basis_c * take_dst_fm(gate_fm, graph, node_k, group), e1, num_edges,
            graph.triplet_e1_offsets
        )


def _voigt(t: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) -> (B, 6) in the order [xx, yy, zz, yz, zx, xy]."""
    return torch.stack(
        [t[:, 0, 0], t[:, 1, 1], t[:, 2, 2], t[:, 1, 2], t[:, 2, 0], t[:, 0, 1]], dim=-1
    )


class M3GNetPotential(nn.Module):
    """Energy/forces/stress from ONE backward pass with respect to the
    (3, E) edge vectors.

    With g_e = dE/dr_e: forces F_i = sum_{e: src=i} g_e - sum_{e: dst=i} g_e;
    stress ``"strain"`` (default) is the PBC virial in pair-force form,
    sym(sum_e r_e (x) g_e) / V per graph; ``"virial"`` is the
    gauge-dependent sum_i r_i (x) F_i / V, kept for parity.

    Call it with a host :class:`GraphBatch` (numpy) or one already moved by
    :func:`to_torch`; float fields are cast to the parameters' dtype.
    ``create_graph=True`` (training) keeps the graph of the backward pass,
    so forces and stress differentiate to the weights; evaluation leaves it
    False.

    ``functional=True`` takes the same pass as a pure function, ``g_fm`` by
    ``torch.func.vjp`` of the energy, with no ``requires_grad_`` and no
    ``torch.autograd.grad``: the form that runs under ``torch.func.vmap``
    over stacked weights (``models.ensemble``), as JAX's potential runs
    under ``jax.vmap``. ``create_graph`` means what it means on the eager
    path: False frees the energy's graph as the backward pass runs (forces
    and stress do not differentiate further), True keeps it for an outer
    ``torch.func`` transform. It runs the three-body stage without
    ``remat_triplets``' checkpoint (``torch.func`` refuses its
    saved-tensor hooks; remat changes no value), and takes no ``group``.
    Both paths assemble forces and stress in :meth:`assemble` and agree at
    f64 to rounding.
    """

    def __init__(self, model: M3GNet, stress_mode: str = "strain"):
        super().__init__()
        if stress_mode not in ("strain", "virial"):
            raise ValueError(f"unknown stress_mode: {stress_mode}")
        self.model = model
        self.stress_mode = stress_mode

    def forward(self, batch, create_graph: bool = False, group=None,
                functional: bool = False) -> PotentialOutput:
        """E/F/S of ``batch``. With ``group`` (a process group), ``batch`` is
        this rank's shard of a partitioned graph
        (``parallel.graph_shard``): forces and atomic energies are its own
        nodes', the energy and the stress the whole graph's."""
        if functional and group is not None:
            raise ValueError("functional=True takes no process group")
        param = self.model.edge_init.kernel
        graph = to_torch(batch, param.device, param.dtype, self.model.batch_index,
                         num_dst_nodes=None if group is None else extended_nodes(batch, group))
        positions, lattice = graph.positions, graph.lattice
        if functional:
            r_fm = edge_vectors_fm(graph, positions, lattice)  # (3, E)

            def total_energy(r):
                energy, atomic = self.model(graph, r, remat=False)
                return energy.sum(), (energy, atomic)

            total, vjp_fn, (energy, atomic) = torch.func.vjp(total_energy, r_fm, has_aux=True)
            (g_fm,) = vjp_fn(torch.ones_like(total), retain_graph=create_graph,
                             create_graph=create_graph)
            return self.assemble(graph, r_fm, g_fm, energy, atomic)
        with torch.enable_grad():
            r_fm = edge_vectors_fm(graph, positions, lattice, group)  # (3, E)
            if not r_fm.requires_grad:
                r_fm.requires_grad_(True)
            energy, atomic = self.model(graph, r_fm, group)
            (g_fm,) = torch.autograd.grad(energy.sum(), r_fm, create_graph=create_graph)  # (3, E)
        return self.assemble(graph, r_fm, g_fm, energy, atomic, group)

    def assemble(self, graph: GraphBatch, r_fm, g_fm, energy, atomic,
                 group=None) -> PotentialOutput:
        """Forces and stress from the edge vectors ``r_fm`` and the energy's
        gradient ``g_fm`` with respect to them, (3, E) each."""
        positions, lattice = graph.positions, graph.lattice
        nb = graph.num_graphs
        src, dst = graph.edge_src, graph.edge_dst
        nmask = graph.node_mask.to(g_fm.dtype)[None, :]
        if group is None:
            dst_sum = segment_sum_fm(g_fm, dst, graph.num_nodes)
        else:  # into the extended rows, then home to their owners
            dst_sum = reduce_extended_fm(
                segment_sum_fm(g_fm, dst, extended_nodes(graph, group)), graph, group)
        forces = ((
            sorted_segment_sum_fm(g_fm, src, graph.num_nodes, graph.edge_src_offsets) - dst_sum
        ) * nmask).t()  # (N, 3)

        volumes = torch.abs(
            (lattice[:, 0] * torch.linalg.cross(lattice[:, 1], lattice[:, 2])).sum(-1)
        )
        if self.stress_mode == "strain":
            edge_graph = graph.node_graph.index_select(0, src)
            outer_fm = (r_fm[:, None, :] * g_fm[None, :, :]).reshape(9, -1)
            per_graph = sorted_segment_sum_fm(outer_fm, edge_graph, nb).t().reshape(-1, 3, 3)
        else:
            outer = positions[:, :, None] * forces[:, None, :]  # (N, 3, 3)
            per_graph = segment_sum(outer.reshape(-1, 9), graph.node_graph, nb).reshape(-1, 3, 3)
        if group is not None:
            energy, per_graph = all_reduce(energy, group), all_reduce(per_graph, group)
        if self.stress_mode == "strain":
            per_graph = 0.5 * (per_graph + per_graph.transpose(1, 2))
        gmask = graph.graph_mask.to(g_fm.dtype)
        stress = _voigt(per_graph) / volumes[:, None] * gmask[:, None]

        n_node = torch.clamp(graph.n_node, min=1).to(energy.dtype)
        return PotentialOutput(
            energy=energy,
            forces=forces,
            stress=stress,
            energy_per_atom=energy / n_node,
            atomic_energy=atomic,
        )


def resolve_device(device) -> torch.device:
    """``None`` means the card. With no card, ``None`` or a CUDA device
    raises rather than run on the CPU unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain versions on the CPU"
        )
    return device


def build_model(config, elemental_energies=None, energy_scale: float = 1.0,
                length_scale: float = 1.0, stress_mode: str = "strain",
                device=None, generator: torch.Generator | None = None) -> M3GNetPotential:
    """Assemble a potential from a config on ``device`` (default: the card).

    Weights are drawn on the CPU from ``generator`` (Flax's initialisers:
    lecun-normal kernels, zero biases) and then moved, so one seed gives the
    same weights on every device, and in every three-body mode (the modes
    share one parameter tree). The model's weights and geometry are f32 (or
    f64 after ``.double()``); ``compute_dtype`` (``"float32"`` or ``None``:
    the weights' dtype; ``"bfloat16"``: see the module docstring) and
    ``remat_triplets`` are the JAX package's.

    The three-body mode resolves as the JAX package's ``build_model`` does:
    ``threebody_mode`` wins when set; under ``"auto"`` the legacy knob
    ``fused_triplets`` wins when set (``"on"`` -> fused, ``"off"`` ->
    gather), and otherwise ``"auto"`` means ``"factorized"`` on the card
    and on the CPU alike (JAX picks gather on its CPU; the port keeps one
    default so that the card and its CPU reference run the same path).
    ``layout="fm"`` with a per-triplet mode raises, as in JAX.

    ``pallas_segment`` is checked and otherwise ignored: the sorted sums
    run the sorted-segment kernel on the card under every value (the JAX
    package's ``"on"``), since it is deterministic, where ``index_add`` is
    not.
    """
    mode = config.threebody_mode
    if mode == "auto":
        if config.fused_triplets != "auto":
            mode = "fused" if config.fused_triplets == "on" else "gather"
        else:
            mode = "factorized"
    if mode not in THREEBODY_MODES:
        raise ValueError(f"unknown threebody_mode: {mode}")
    if config.layout == "fm" and mode != "factorized":
        raise ValueError("layout='fm' requires threebody_mode='factorized'")
    if config.pallas_segment not in PALLAS_SEGMENT:
        raise ValueError(f"unknown pallas_segment: {config.pallas_segment!r}")
    compute_dtype = None
    if config.compute_dtype not in ("float32", None):
        compute_dtype = getattr(torch, str(config.compute_dtype), None)
        if not (isinstance(compute_dtype, torch.dtype) and compute_dtype.is_floating_point):
            raise ValueError(f"unknown compute_dtype: {config.compute_dtype!r}")
    device = resolve_device(device)
    if device.type == "cuda":
        # Full-f32 matmuls, as the reference semantics need: no TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = M3GNet(
        cutoff=config.cutoff,
        threebody_cutoff=config.threebody_cutoff,
        l_max=config.l_max,
        n_max=config.n_max,
        num_types=config.num_types,
        embedding_dim=config.embedding_dim,
        num_blocks=config.num_blocks,
        elemental_energies=tuple(elemental_energies or ()),
        energy_scale=energy_scale,
        length_scale=length_scale,
        threebody_mode=mode,
        compute_dtype=compute_dtype,
        remat_triplets=bool(config.remat_triplets),
        generator=generator,
    )
    return M3GNetPotential(model, stress_mode=stress_mode).to(device)

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
strain stress by ``edge_graph``.

- :func:`edge_vectors_fm` builds the (3, E) pair vectors from positions,
  cell shifts and lattices;
- :class:`M3GNet` maps a batch and those vectors to per-graph energies;
- :class:`M3GNetPotential` takes ONE backward pass with respect to the edge
  vectors, from which forces and stress are assembled (``create_graph=True``
  keeps its graph, so a loss on forces and stress differentiates to the
  weights);
- :func:`build_model` assembles a potential from a config on a device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from torch_m3gnet_tpu_torch.data.graph import GraphBatch, to_torch
from torch_m3gnet_tpu_torch.models.layers import DenseFM, Embed, GatedMLPFM
from torch_m3gnet_tpu_torch.ops.basis import (
    cutoff_poly,
    legendre_cos_all,
    normalized_spherical_bessel,
    real_racah_harmonics_fm,
    smooth_radial_basis_fm,
)
from torch_m3gnet_tpu_torch.ops.factorized_stage import q_scatter, r1_gather
from torch_m3gnet_tpu_torch.ops.fused_triplet import fused_triplet_gate_sum, triplet_e2_order
from torch_m3gnet_tpu_torch.ops.segment import segment_sum, segment_sum_fm, take_fm
from torch_m3gnet_tpu_torch.ops.sorted_segment import sorted_segment_offsets, sorted_segment_sum_fm
from torch_m3gnet_tpu_torch.ops.windowed_take import windowed_take_fm

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


def edge_vectors_fm(graph: GraphBatch, positions: torch.Tensor,
                    lattice: torch.Tensor) -> torch.Tensor:
    """(3, E) pair vectors r_e = pos[dst] + shift @ lattice[graph] - pos[src]."""
    pos_fm = positions.t()  # (3, N)
    edge_graph = graph.node_graph.index_select(0, graph.edge_src)  # (E,)
    lat_e = take_fm(lattice.reshape(-1, 9).t(), edge_graph)  # (9, E): rows lattice[p, q]
    shift_fm = graph.edge_cell_shift.to(positions.dtype).t()  # (3, E)
    shift_vec = torch.stack(
        [sum(shift_fm[p] * lat_e[3 * p + q] for p in range(3)) for q in range(3)]
    )
    return take_fm(pos_fm, graph.edge_dst) + shift_vec - take_fm(pos_fm, graph.edge_src)


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
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if threebody_mode not in THREEBODY_MODES:
            raise ValueError(f"unknown threebody_mode: {threebody_mode}")
        self.threebody_mode = threebody_mode
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

    @property
    def batch_index(self) -> tuple[str, ...]:
        """The parts of the per-batch kernel index (``data.to_torch``) that
        this mode reads: the ``edge_src`` offsets in every mode (the node
        aggregation and the forces), the ``triplet_e1`` offsets in the
        gather and fused modes, the e2 order in the fused mode."""
        extra = {"gather": ("triplet_e1_offsets",),
                 "fused": ("triplet_e1_offsets", "triplet_e2_order", "triplet_e2_offsets")}
        return ("edge_src_offsets",) + extra.get(self.threebody_mode, ())

    def forward(self, graph: GraphBatch, r_vec_fm: torch.Tensor):
        """Returns (per-graph energy (B,), per-atom energy (N,)), both in eV."""
        dtype = r_vec_fm.dtype
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

        # --- featurization
        v_fm = self.atom_embed(graph.atom_types).t()  # (D, N)
        ew_fm = smooth_radial_basis_fm(dist, n_max, rc)  # (n, E)
        e_fm = F.silu(self.edge_init(ew_fm))  # (D, E)

        if self.threebody_mode == "factorized":
            triplet_aggregate = self._factorized_stage(graph, r_fm, dist)
        else:
            triplet_aggregate = self._triplet_stage(graph, r_fm, dist)

        # --- interaction blocks
        for b in range(self.num_blocks):
            gate_fm = torch.sigmoid(getattr(self, f"three_gate_{b}")(v_fm))  # (ln, N)
            e_fm = e_fm + getattr(self, f"three_mlp_{b}")(triplet_aggregate(gate_fm))

            vi = take_fm(v_fm, src)
            vj = take_fm(v_fm, dst)
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

        # --- readout
        atomic = self.readout(v_fm)[0]  # (N,)
        elem = self.elemental_energies.to(dtype).index_select(0, graph.atom_types)
        scaled_atomic = (elem / self.energy_scale + atomic) * node_mask
        scaled_total = segment_sum(scaled_atomic, graph.node_graph, graph.num_graphs)
        total = self.energy_scale * scaled_total * graph.graph_mask.to(dtype)
        return total, self.energy_scale * scaled_atomic

    def _factorized_stage(self, graph: GraphBatch, r_fm, dist):
        """The factorized three-body stage: gate (LN, N) -> (LN, E), from
        per-edge factors only (the j = k diagonal that the triplet
        enumeration excludes is subtracted analytically, P_l(1) = 1)."""
        l_max, n_max = self.l_max, self.n_max
        ln, num_edges = l_max * n_max, graph.num_edges
        rc = self.cutoff / self.length_scale
        rc3 = self.threebody_cutoff / self.length_scale
        src, dst = graph.edge_src, graph.edge_dst
        u_fm = r_fm / dist[None, :]  # padded edges: dist = rc > 0
        sh_fm = real_racah_harmonics_fm(u_fm, l_max)  # (M, E)
        chi_fm = normalized_spherical_bessel(dist, rc, l_max, n_max)  # (l, n, E)
        fc_e = cutoff_poly(dist, rc3) * graph.edge_mask.to(dist.dtype)  # zero on padded edges
        chifc = (chi_fm * fc_e).reshape(ln, num_edges)
        fcn = torch.stack([c * fc_e for c in self.sph_norm])  # (l, E)
        fcn = fcn[:, None, :].expand(l_max, n_max, num_edges).reshape(ln, num_edges)

        def triplet_aggregate(gate_fm):
            # A padded edge has gm = 0 (fc_e carries the edge mask), so it
            # adds nothing to A and its own output is scaled by fcn = 0.
            g = chifc * take_fm(gate_fm, dst)  # (ln, E)
            a = q_scatter(sh_fm, g, src, graph.num_nodes, l_max, n_max)  # (M*n, N)
            proj = r1_gather(a, sh_fm, src, l_max, n_max)  # (ln, E)
            return fcn * (proj - g)

        return triplet_aggregate

    def _triplet_stage(self, graph: GraphBatch, r_fm, dist):
        """The per-triplet three-body stage (fused or gather): gate (LN, N)
        -> (LN, E) with out[:, e] = sum_{t: e1[t]=e} basis[:, t] *
        gate[:, k(t)], basis (LN, T) = chi_ln(r_ik) c_l P_l(cos jik)
        fc(r_ij) fc(r_ik), zeroed on padded triplets."""
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
        chi = normalized_spherical_bessel(rik, rc, l_max, n_max)  # (l, n, T)
        # The mask stays: padded triplets point at real edges (e2 = 0), and
        # it is what zeroes their gradient.
        basis_fm = (chi * sph[:, None, :] * fc).reshape(l_max * n_max, -1)
        basis_fm = basis_fm * graph.triplet_mask.to(basis_fm.dtype)

        if fused:
            # gate pre-gathered node -> edge (E-scale); the kernel's T-scale
            # reads of it by e2 are then window-local. The e2 order goes with
            # it, for the backward kernel's sum by e2.
            return lambda gate_fm: fused_triplet_gate_sum(
                basis_fm, take_fm(gate_fm, dst), e1, e2, num_edges, e2_order
            )
        node_k = graph.triplet_node_k
        if node_k is None:
            node_k = dst.index_select(0, e2)
        return lambda gate_fm: sorted_segment_sum_fm(
            basis_fm * take_fm(gate_fm, node_k), e1, num_edges, graph.triplet_e1_offsets
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
    """

    def __init__(self, model: M3GNet, stress_mode: str = "strain"):
        super().__init__()
        if stress_mode not in ("strain", "virial"):
            raise ValueError(f"unknown stress_mode: {stress_mode}")
        self.model = model
        self.stress_mode = stress_mode

    def forward(self, batch, create_graph: bool = False) -> PotentialOutput:
        param = self.model.edge_init.kernel
        graph = to_torch(batch, param.device, param.dtype, self.model.batch_index)
        positions, lattice = graph.positions, graph.lattice
        nb = graph.num_graphs
        with torch.enable_grad():
            r_fm = edge_vectors_fm(graph, positions, lattice)  # (3, E)
            if not r_fm.requires_grad:
                r_fm.requires_grad_(True)
            energy, atomic = self.model(graph, r_fm)
            (g_fm,) = torch.autograd.grad(energy.sum(), r_fm, create_graph=create_graph)  # (3, E)

        src, dst = graph.edge_src, graph.edge_dst
        nmask = graph.node_mask.to(g_fm.dtype)[None, :]
        forces = ((
            sorted_segment_sum_fm(g_fm, src, graph.num_nodes, graph.edge_src_offsets)
            - segment_sum_fm(g_fm, dst, graph.num_nodes)
        ) * nmask).t()  # (N, 3)

        volumes = torch.abs(
            (lattice[:, 0] * torch.linalg.cross(lattice[:, 1], lattice[:, 2])).sum(-1)
        )
        if self.stress_mode == "strain":
            edge_graph = graph.node_graph.index_select(0, src)
            outer_fm = (r_fm[:, None, :] * g_fm[None, :, :]).reshape(9, -1)
            per_graph = sorted_segment_sum_fm(outer_fm, edge_graph, nb).t().reshape(-1, 3, 3)
            per_graph = 0.5 * (per_graph + per_graph.transpose(1, 2))
        else:
            outer = positions[:, :, None] * forces[:, None, :]  # (N, 3, 3)
            per_graph = segment_sum(outer.reshape(-1, 9), graph.node_graph, nb).reshape(-1, 3, 3)
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
    share one parameter tree). The model computes in f32 or f64 on one
    device.

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
    if config.compute_dtype not in ("float32", None):
        raise NotImplementedError(
            f"compute_dtype={config.compute_dtype!r} comes with a later slice "
            "of the port; this one computes in float32 (or float64)"
        )
    if config.remat_triplets:
        raise NotImplementedError(
            "remat_triplets=True (rematerialising the three-body stage in the "
            "backward pass) comes with a later slice of the port"
        )
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
        generator=generator,
    )
    return M3GNetPotential(model, stress_mode=stress_mode).to(device)

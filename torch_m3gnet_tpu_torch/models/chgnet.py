"""CHGNet in PyTorch, feature-major: a potential whose bond graph carries
features on every angle.

Deng et al., "CHGNet as a pretrained universal neural network potential
for charge-informed atomistic modelling", Nat. Mach. Intell. 5, 1031
(2023), arXiv:2302.14231 (Methods). With t the layer, (+) concatenation,
phi a gated MLP SiLU(LN(core)) * sigmoid(LN(gate)) (``NormGatedMLPFM``) and
L a linear layer:

- inputs: v_i = embedding of Z_i; e_ij = W RBF(r_ij), a radial Bessel basis
  with learnable frequencies under a smooth envelope at ``cutoff`` (the
  atom graph); a_ijk = W Fourier(theta_ijk) for the ordered pairs of bonds
  within ``bond_graph_cutoff`` that share their centre atom j (the bond
  graph, the batch's triplets); the bond weights w_ag = W RBF_ag(r) and
  w_bg = W RBF_bg(r), the second basis at the bond-graph cutoff;
- atom conv: v_i += L_v(sum_j w_ag,ij * phi_v(v_i (+) v_j (+) e_ij));
- bond conv: e_jk += L_e(sum_i w_bg,ij w_bg,jk * phi_e(e_ij (+) e_jk (+)
  a_ijk (+) v_j));
- angle update: a_ijk += phi_a(e_ij (+) e_jk (+) a_ijk (+) v_j);
- ``num_atom_convs`` atom convs with a bond conv and an angle update after
  each but the last; the magnetic moment m_i = |L_m(v_i)| read after the
  third (the last but one) atom conv. The angle update after the last bond
  conv would feed nothing and is left out (CHGNet's released code computes
  it and discards it);
- the energy: an MLP of the last v_i plus the species' reference energy
  (the linear composition model), summed over the atoms (the per-atom
  average times the atom count).

One feature per undirected bond: the bond conv's sums over the angles of
each directed edge (by ``triplet_e1``) are added over the edge and its
reverse (the batch's ``edge_reverse``, ``pack_structures(...,
bond_pairs=True)``), so both directions of a bond carry the same update.
The angle is atan2(|r_ij x r_ik|, r_ij . r_ik), which equals
acos(cos theta) and keeps its precision near 0 and pi.

The bond graph's gathers and sums run through the fused mode's kernels,
indexed as there: ``ops.windowed_take`` (B6) reads edge rows at the
angles' ``triplet_e1`` (along its offsets) and ``triplet_e2`` (along the
e2 order), its transpose (B7) sums the bond conv by ``triplet_e1``; the
atom conv gathers by ``take_dst_fm`` and sums by ``edge_src`` in B8
(``ops.sorted_segment``). Every dense layer is a float32 cuBLAS matmul on
the card (``build_model`` turns TF32 off); each phi's tail (its last
biases, both LayerNorms and the gate) is one hand-written kernel each way
(``ops.norm_gate``).

While a torch profiler records, each atom conv runs in a
``chgnet.atom_conv`` span, and the angles' set-up (geometry, Fourier basis,
pair weights) and each bond conv with its angle update in a
``chgnet.bond_graph`` span (``utils.profiling``); every forward adds the
batch's real angles and bonds (undirected) to the counters
``chgnet.angles`` and ``chgnet.bonds`` (summed on the device, read by
``counts()``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from torch_m3gnet_tpu_torch.data.graph import GraphBatch
from torch_m3gnet_tpu_torch.models.layers import DenseFM, Embed, NormGatedMLPFM
from torch_m3gnet_tpu_torch.ops.basis import bessel_rbf_fm, fourier_basis_fm
from torch_m3gnet_tpu_torch.ops.segment import segment_sum, take_fm
from torch_m3gnet_tpu_torch.ops.sorted_segment import sorted_segment_sum_fm
from torch_m3gnet_tpu_torch.ops.windowed_take import windowed_scatter_fm, windowed_take_fm
from torch_m3gnet_tpu_torch.utils.profiling import span

# The published bases: 31 radial functions, and the Fourier basis of the
# angle to order 15 (1 + 2 x 15 functions); the radial envelope's degree.
NUM_RADIAL, NUM_ANGULAR, ENVELOPE_P = 31, 31, 8

class RadialBessel(nn.Module):
    """The radial Bessel basis of ``NUM_RADIAL`` functions with learnable
    ``frequencies`` (n pi at start) under the polynomial envelope of degree
    ``ENVELOPE_P`` at ``cutoff``."""

    def __init__(self, cutoff: float):
        super().__init__()
        self.cutoff = cutoff
        self.frequencies = nn.Parameter(math.pi * torch.arange(1, NUM_RADIAL + 1,
                                                               dtype=torch.float32))

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return bessel_rbf_fm(r, self.frequencies, self.cutoff, ENVELOPE_P)


class Conv(nn.Module):
    """One convolution: its gated MLP ``phi`` and, where it has one, the
    linear layer ``out`` applied to the summed messages."""

    def __init__(self, in_features: int, width: int, hidden: Sequence[int], out: bool,
                 generator):
        super().__init__()
        self.phi = NormGatedMLPFM(in_features, width, hidden, generator=generator)
        self.out = DenseFM(width, width, generator=generator) if out else None


class CHGNet(nn.Module):
    """Energy model: batch + (3, E) edge vectors -> (energy (B,), atomic
    energy (N,), magnetic moment (N,)).

    Parameters by the paper's blocks: ``atom_embedding``, ``rbf_ag`` and
    ``rbf_bg`` (the two radial bases' frequencies), ``bond_embedding``,
    ``bond_weights_ag``, ``bond_weights_bg``, ``angle_embedding``,
    ``atom_conv_{t}``, ``bond_conv_{t}``, ``angle_update_{t}`` (each a
    ``phi`` and, for the convs, an ``out``), ``site_wise`` (the magnetic
    moment's linear layer) and ``readout``.
    """

    def __init__(
        self,
        cutoff: float = 5.0,
        bond_graph_cutoff: float = 3.0,
        num_types: int = 94,
        width: int = 64,
        num_atom_convs: int = 4,
        elemental_energies: Sequence[float] = (),
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if num_atom_convs < 2:
            raise ValueError("CHGNet reads the magnetic moment after the last but one atom conv: "
                             f"num_atom_convs must be >= 2, got {num_atom_convs}")
        self.cutoff, self.bond_graph_cutoff = cutoff, bond_graph_cutoff
        self.num_atom_convs, self.order = num_atom_convs, NUM_ANGULAR // 2
        d, gen = width, generator
        # The released code's hidden widths (64, the width): one hidden layer
        # in the convs' phi, none in the angle update's, three in the readout.
        conv_hidden, angle_hidden, readout_hidden = (d,), (), (d, d, d)

        self.atom_embedding = Embed(num_types, d, gen)
        self.rbf_ag = RadialBessel(cutoff)
        self.rbf_bg = RadialBessel(bond_graph_cutoff)
        self.bond_embedding = DenseFM(NUM_RADIAL, d, use_bias=False, generator=gen)
        self.bond_weights_ag = DenseFM(NUM_RADIAL, d, use_bias=False, generator=gen)
        self.bond_weights_bg = DenseFM(NUM_RADIAL, d, use_bias=False, generator=gen)
        self.angle_embedding = DenseFM(NUM_ANGULAR, d, use_bias=False, generator=gen)
        for t in range(num_atom_convs):
            self.add_module(f"atom_conv_{t}", Conv(3 * d, d, conv_hidden, True, gen))
        for t in range(num_atom_convs - 1):
            self.add_module(f"bond_conv_{t}", Conv(4 * d, d, conv_hidden, True, gen))
        for t in range(num_atom_convs - 2):
            self.add_module(f"angle_update_{t}", Conv(4 * d, d, angle_hidden, False, gen))
        self.site_wise = DenseFM(d, 1, generator=gen)
        dims = [d, *readout_hidden, 1]
        self.readout = nn.ModuleList(DenseFM(dims[i], dims[i + 1], generator=gen)
                                     for i in range(len(dims) - 1))

        elem = np.zeros(num_types) if len(elemental_energies) == 0 else np.asarray(
            elemental_energies, dtype=np.float64)
        # The composition model: a fixed input, float64, cast at use.
        self.register_buffer("elemental_energies", torch.as_tensor(elem, dtype=torch.float64),
                             persistent=False)

    @property
    def batch_index(self) -> tuple[str, ...]:
        """The per-batch index that ``data.to_torch`` gives this model: the
        ``edge_src`` offsets (the atom conv's sums), the ``triplet_e1``
        offsets and the e2 order (the bond graph's takes and sums), as the
        fused M3GNet mode reads them, and the bond pairs ``edge_reverse``,
        which the batch carries from pack time (``bond_pairs=True``)."""
        return ("edge_src_offsets", "triplet_e1_offsets", "triplet_e2_order",
                "triplet_e2_offsets", "edge_reverse")

    def forward(self, graph: GraphBatch, r_vec_fm: torch.Tensor, group=None,
                remat: bool | None = None):
        """Returns (per-graph energy (B,), per-atom energy (N,), magnetic
        moment (N,)), in eV and Bohr magnetons. ``remat`` is accepted for the
        potential's sake and changes nothing; a process group is refused
        (the model has no graph-parallel path)."""
        if group is not None:
            raise ValueError("CHGNet has no graph-parallel path: group must be None")
        from torch_m3gnet_tpu_torch.models.m3gnet import take_dst_fm
        from torch_m3gnet_tpu_torch.utils.profiling import count

        dtype = r_vec_fm.dtype
        num_nodes, num_edges = graph.num_nodes, graph.num_edges
        src, dst = graph.edge_src, graph.edge_dst
        e1, e2 = graph.triplet_e1, graph.triplet_e2
        edge_mask = graph.edge_mask.to(dtype)
        trip_mask = graph.triplet_mask
        count("chgnet.angles", trip_mask.sum())
        count("chgnet.bonds", graph.edge_mask.sum() // 2)

        # --- geometry. Padded edges get distance rc (not 0); the inner where
        # keeps sqrt's gradient finite there.
        sq = (r_vec_fm * r_vec_fm).sum(0)
        dist = torch.where(graph.edge_mask, torch.sqrt(torch.where(graph.edge_mask, sq,
                                                                   torch.ones_like(sq))),
                           torch.full_like(sq, self.cutoff))
        rbf_ag = self.rbf_ag(dist)  # (n, E)
        e_fm = self.bond_embedding(rbf_ag)  # (D, E)
        w_ag = self.bond_weights_ag(rbf_ag) * edge_mask
        w_bg = self.bond_weights_bg(self.rbf_bg(dist)) * edge_mask

        # --- the bond graph: the batch's owners of e1 (its offsets; e1 is
        # sorted) and of e2 (the e2 order)
        own1 = (None, graph.triplet_e1_offsets)
        own2 = (graph.triplet_e2_order, graph.triplet_e2_offsets)

        def at_angles(x_fm):  # (F, E) -> the rows of each angle's two bonds, (F, T) each
            return windowed_take_fm(x_fm, e1, own1), windowed_take_fm(x_fm, e2, own2)

        with span("chgnet.bond_graph"):
            g1, g2 = at_angles(r_vec_fm)  # (3, T)
            cross = torch.linalg.cross(g1, g2, dim=0)
            s2, cos = (cross * cross).sum(0), (g1 * g2).sum(0)
            # atan2(|r1 x r2|, r1 . r2); padded angles (and exactly collinear
            # ones, where the sine's gradient is undefined) take safe values.
            ok = trip_mask & (s2 > 0)
            sin = torch.where(ok, torch.sqrt(torch.where(ok, s2, torch.ones_like(s2))),
                              torch.zeros_like(s2))
            theta = torch.atan2(sin, torch.where(trip_mask, cos, torch.ones_like(cos)))
            a_fm = self.angle_embedding(fourier_basis_fm(theta, self.order))  # (D, T)
            wa, wb = at_angles(w_bg)
            w_pair = wa * wb * trip_mask.to(dtype)

        v_fm = self.atom_embedding(graph.atom_types).t()  # (D, N)
        magmom = None
        for t in range(self.num_atom_convs):
            conv = getattr(self, f"atom_conv_{t}")
            with span("chgnet.atom_conv"):
                concat = torch.cat([take_fm(v_fm, src), take_dst_fm(v_fm, graph, dst), e_fm], 0)
                msg = conv.phi(concat) * w_ag
                v_fm = v_fm + conv.out(sorted_segment_sum_fm(msg, src, num_nodes,
                                                             graph.edge_src_offsets))
            if t == self.num_atom_convs - 2:
                magmom = torch.abs(self.site_wise(v_fm)[0])
            if t == self.num_atom_convs - 1:
                break
            bond = getattr(self, f"bond_conv_{t}")
            with span("chgnet.bond_graph"):
                # the centre atom j of each angle: the source of its bonds
                v_centre = windowed_take_fm(take_fm(v_fm, src), e1, own1)  # (D, T)
                ea, eb = at_angles(e_fm)
                upd = bond.phi(torch.cat([ea, eb, a_fm, v_centre], 0)) * w_pair
                per_edge = windowed_scatter_fm(upd, e1, num_edges, own1)  # (D, E)
                # one feature per bond: the angles at both of its ends
                per_bond = per_edge + take_fm(per_edge, graph.edge_reverse)
                e_fm = e_fm + bond.out(per_bond)
                if t < self.num_atom_convs - 2:
                    ea, eb = at_angles(e_fm)
                    angle = getattr(self, f"angle_update_{t}")
                    a_fm = a_fm + angle.phi(torch.cat([ea, eb, a_fm, v_centre], 0))

        h = v_fm
        for i, layer in enumerate(self.readout):
            h = layer(h)
            if i < len(self.readout) - 1:
                h = F.silu(h)
        node_mask = graph.node_mask.to(dtype)
        elem = self.elemental_energies.to(dtype).index_select(0, graph.atom_types)
        atomic = (h[0] + elem) * node_mask
        total = segment_sum(atomic, graph.node_graph, graph.num_graphs) * graph.graph_mask.to(dtype)
        return total, atomic, magmom * node_mask

"""The fused three-body message stage: CUDA kernels, plain versions, autograd.

Counterpart of ``torch_m3gnet_tpu.ops.pallas_fused_triplet``. Per block the
fused three-body mode (``models/m3gnet.py``) computes

    out[:, e] = sum_{t: e1[t]=e} basis[:, t] * gate_e[:, e2[t]]      (LN,T),(LN,E) -> (LN,E)

and its VJP, itself a first-class op:

    backward_pair(basis, gate_e, g) = (dB, dG),
    dB[:, t] = g[:, e1[t]] * gate_e[:, e2[t]]                        (LN, T)
    dG[:, e] = sum_{t: e2[t]=e} g[:, e1[t]] * basis[:, t]            (LN, E)

``e1`` (the triplet's i->j edge) is int32, sorted ascending, in [0, E): the
forward kernel takes each edge's run of triplets from an offsets pass over
it. ``e2`` (the i->k edge) is int32 in [0, E), unsorted. Padded triplets
carry zero basis. The backward kernel sums ``dG`` by ``e2`` through the
batch's e2 order, ``e2_order = (order, offsets)`` from
:func:`triplet_e2_order`: a property of the batch, which ``data.to_torch``
builds once per batch for the fused mode (``GraphBatch.triplet_e2_order`` /
``triplet_e2_offsets``) and the model passes in; the forward keeps it for
the backward and the double backward. Both ops take it; the plain
versions do not read it.

Each op has a hand-written CUDA kernel (``csrc/fused_triplet.cu``), a plain
torch version (``*_plain``) and an ``autograd.Function``. The Function runs
the kernel on a CUDA tensor and the plain version on a CPU tensor, in the
tensor's dtype; on CUDA there is no fallback. Both outputs of the pair are
bilinear, so the VJPs close over the two ops (as ``_vjp_bwd`` and
``_pair_bwd`` in the JAX module):

    d fused / d(basis, gate_e) = backward_pair(basis, gate_e, g)
    d backward_pair / d(basis, gate_e) = backward_pair(u_b, u_g, g)
    d backward_pair / d g = fused(u_b, gate_e) + fused(basis, u_g)

and ``create_graph=True`` works to any order.

Under ``torch.func`` (``vmap``, ``grad``, ``vjp``) the Functions take their
float operands as (rows, cols), shared, or with a leading member axis,
(K, rows, cols) (``ops._vmap``). The kernels have a member axis, as JAX's
``vmap`` of a ``pallas_call`` gives its grid one: K members are one launch,
each operand passed once with its member stride (0 where the members share
it), the outputs K contiguous slabs, each bitwise equal to that member's own
call. On the CPU the plain version runs per member.

Each call that launches an op's kernel adds one to the counter
``launch.<op>`` of ``utils.profiling`` (CUDA path only): one per call,
whatever K.
"""

from __future__ import annotations

import torch

from torch_m3gnet_tpu_torch.ops import _cuda, _vmap
from torch_m3gnet_tpu_torch.ops.segment import segment_sum_fm, take_fm

# The forward kernel is instantiated for LN = 1..16 rows (csrc/fused_triplet.cu).
KERNEL_MAX_ROWS = 16


# ---------------------------------------------------------------------------
# Plain versions (the counterparts of reference_triplet_gate_sum and of the
# XLA autodiff of it). The CPU path runs these; on the card they are the
# reference that chip_smoke.py holds the kernels against.
# ---------------------------------------------------------------------------


def fused_triplet_gate_sum_plain(basis_fm, gate_e_fm, e1, e2, num_edges: int):
    """(LN, T), (LN, E), (T,), (T,) -> (LN, num_edges)."""
    return segment_sum_fm(basis_fm * take_fm(gate_e_fm, e2), e1, num_edges)


def backward_pair_plain(basis_fm, gate_e_fm, g, e1, e2, num_edges: int):
    """(LN, T), (LN, E), (LN, E), (T,), (T,) -> ((LN, T), (LN, num_edges))."""
    g1 = take_fm(g, e1)
    return g1 * take_fm(gate_e_fm, e2), segment_sum_fm(g1 * basis_fm, e2, num_edges)


def triplet_e2_order(e2: torch.Tensor, num_edges: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The e2 order of a batch, on ``e2``'s device: ``order`` (T,) int32, the
    stable permutation that sorts ``e2`` (so each edge's triplets keep
    ascending t), and ``offsets`` (num_edges + 1,) int32, where edge e owns
    ``order[offsets[e]:offsets[e + 1]]``. One device sort, once per batch:
    what the backward kernel's sorted-owner sum of dG needs, as JAX's
    ``_prep`` computes its tiles' window bounds."""
    sorted_e2, order = torch.sort(e2, stable=True)
    edges = torch.arange(num_edges + 1, dtype=sorted_e2.dtype, device=e2.device)
    offsets = torch.searchsorted(sorted_e2, edges)
    return order.to(torch.int32), offsets.to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check(name, e1, e2, num_edges, pairs, order, off2):
    """Validate the shapes (every path): each float operand (rows, cols) or
    (K, rows, cols), one K for all. Returns (K or None, True when the
    operands are on CUDA, False for the CPU path)."""
    t = e1.shape[0] if e1.dim() == 1 else -1
    if e1.dim() != 1 or tuple(e2.shape) != (t,):
        raise ValueError(
            f"{name}: e1 and e2 must be 1-D of one length, got "
            f"{tuple(e1.shape)} and {tuple(e2.shape)}"
        )
    if tuple(order.shape) != (t,) or tuple(off2.shape) != (num_edges + 1,):
        raise ValueError(
            f"{name}: the e2 order must be ({t},) and ({num_edges + 1},), got "
            f"{tuple(order.shape)} and {tuple(off2.shape)}"
        )
    k = _vmap.members(name, [(label, x) for label, x, _ in pairs])
    rows = pairs[0][1].shape[-2]
    for label, x, cols in pairs:
        want = (rows, t if cols == "T" else num_edges)
        if tuple(x.shape[-2:]) != want:
            raise ValueError(f"{name}: {label} has shape {tuple(x.shape)}, expected "
                             f"([K,] {want[0]}, {want[1]})")
    indices = [("e1", e1), ("e2", e2), ("e2 order", order), ("e2 offsets", off2)]
    return k, _cuda.is_cuda(name, [(label, x) for label, x, _ in pairs], indices)


def _rows(name, rows):
    if not 1 <= rows <= KERNEL_MAX_ROWS:
        raise ValueError(f"{name}: the CUDA kernel is built for 1..{KERNEL_MAX_ROWS} rows, got {rows}")


def _forward(basis_fm, gate_e_fm, e1, e2, num_edges, order, off2):
    name = "fused_triplet_gate_sum"
    pairs = [("basis", basis_fm, "T"), ("gate_e", gate_e_fm, "E")]
    k, cuda = _check(name, e1, e2, num_edges, pairs, order, off2)
    if not cuda:
        return _vmap.per_member(fused_triplet_gate_sum_plain, k, (basis_fm, gate_e_fm),
                                (e1, e2, num_edges))
    rows, t = basis_fm.shape[-2:]
    _rows(name, rows)
    lead = () if k is None else (k,)
    out = torch.empty((*lead, rows, num_edges), dtype=torch.float32, device=basis_fm.device)
    if out.numel() == 0:  # nothing to compute: a zero-size grid is an error
        return out
    (b, b_stride), (g, g_stride) = (_vmap.kernel_operand(x) for x in (basis_fm, gate_e_fm))
    # the offsets pass runs once for every member: e1 is shared
    offsets = torch.empty(num_edges + 1, dtype=torch.int32, device=out.device)
    _cuda.launch(name, "m3g_fused_triplet_gate_sum", out.device,
                 b.data_ptr(), g.data_ptr(), e1.data_ptr(), e2.data_ptr(), offsets.data_ptr(),
                 out.data_ptr(), rows, num_edges, t, k or 1, b_stride, g_stride)
    return out


def _backward(basis_fm, gate_e_fm, g, e1, e2, num_edges, order, off2):
    name = "backward_pair"
    pairs = [("basis", basis_fm, "T"), ("gate_e", gate_e_fm, "E"), ("g", g, "E")]
    k, cuda = _check(name, e1, e2, num_edges, pairs, order, off2)
    if not cuda:
        return _vmap.per_member(backward_pair_plain, k, (basis_fm, gate_e_fm, g),
                                (e1, e2, num_edges))
    rows, t = basis_fm.shape[-2:]
    _rows(name, rows)
    dev, lead = basis_fm.device, () if k is None else (k,)
    d_basis = torch.empty((*lead, rows, t), dtype=torch.float32, device=dev)
    if d_basis.numel() == 0:  # no triplets: nothing to launch
        return d_basis, torch.zeros((*lead, rows, num_edges), dtype=torch.float32, device=dev)
    d_gate = torch.empty((*lead, rows, num_edges), dtype=torch.float32, device=dev)
    (b, b_stride), (q, q_stride), (c, c_stride) = (
        _vmap.kernel_operand(x) for x in (basis_fm, gate_e_fm, g))
    _cuda.launch(name, "m3g_backward_pair", dev,
                 b.data_ptr(), q.data_ptr(), c.data_ptr(), e1.data_ptr(), e2.data_ptr(),
                 order.data_ptr(), off2.data_ptr(), d_basis.data_ptr(), d_gate.data_ptr(),
                 rows, num_edges, t, k or 1, b_stride, q_stride, c_stride)
    return d_basis, d_gate


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class FusedTripletGateSum(torch.autograd.Function):
    @staticmethod
    def forward(basis_fm, gate_e_fm, e1, e2, num_edges, order, off2):
        return _forward(basis_fm, gate_e_fm, e1, e2, num_edges, order, off2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        basis_fm, gate_e_fm, e1, e2, num_edges, order, off2 = inputs
        ctx.save_for_backward(basis_fm, gate_e_fm, e1, e2, order, off2)
        ctx.num_edges = num_edges

    @staticmethod
    def backward(ctx, g):
        basis_fm, gate_e_fm, e1, e2, order, off2 = ctx.saved_tensors
        d_basis, d_gate = BackwardPair.apply(basis_fm, gate_e_fm, g, e1, e2, ctx.num_edges,
                                             order, off2)
        return (_vmap.reduce_to(d_basis, basis_fm), _vmap.reduce_to(d_gate, gate_e_fm),
                None, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, basis_fm, gate_e_fm, e1, e2, num_edges, order, off2):
        _vmap.shared_index("fused_triplet_gate_sum", in_dims,
                           {"e1": 2, "e2": 3, "e2 order": 5, "e2 offsets": 6})
        basis_fm, gate_e_fm = _vmap.batch_first("fused_triplet_gate_sum", in_dims[:2],
                                                (basis_fm, gate_e_fm))
        return FusedTripletGateSum.apply(basis_fm, gate_e_fm, e1, e2, num_edges, order, off2), 0


class BackwardPair(torch.autograd.Function):
    @staticmethod
    def forward(basis_fm, gate_e_fm, g, e1, e2, num_edges, order, off2):
        return _backward(basis_fm, gate_e_fm, g, e1, e2, num_edges, order, off2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        basis_fm, gate_e_fm, g, e1, e2, num_edges, order, off2 = inputs
        ctx.save_for_backward(basis_fm, gate_e_fm, g, e1, e2, order, off2)
        ctx.num_edges = num_edges

    @staticmethod
    def backward(ctx, u_b, u_g):
        basis_fm, gate_e_fm, g, e1, e2, order, off2 = ctx.saved_tensors
        e = ctx.num_edges
        # d/dB <u_g, dG> = g[:, e1] * u_g[:, e2] and d/dG <u_b, dB> =
        # scatter_e2(g[:, e1] * u_b): one backward_pair call with (u_b, u_g).
        g_basis, g_gate = BackwardPair.apply(u_b, u_g, g, e1, e2, e, order, off2)
        g_g = None
        if ctx.needs_input_grad[2]:
            g_g = (FusedTripletGateSum.apply(u_b, gate_e_fm, e1, e2, e, order, off2)
                   + FusedTripletGateSum.apply(basis_fm, u_g, e1, e2, e, order, off2))
        return (_vmap.reduce_to(g_basis, basis_fm), _vmap.reduce_to(g_gate, gate_e_fm),
                _vmap.reduce_to(g_g, g), None, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, basis_fm, gate_e_fm, g, e1, e2, num_edges, order, off2):
        _vmap.shared_index("backward_pair", in_dims,
                           {"e1": 3, "e2": 4, "e2 order": 6, "e2 offsets": 7})
        basis_fm, gate_e_fm, g = _vmap.batch_first("backward_pair", in_dims[:3],
                                                   (basis_fm, gate_e_fm, g))
        return BackwardPair.apply(basis_fm, gate_e_fm, g, e1, e2, num_edges, order, off2), (0, 0)


def fused_triplet_gate_sum(basis_fm, gate_e_fm, e1, e2, num_edges: int,
                           e2_order) -> torch.Tensor:
    """out[:, e] = sum_{t: e1[t]=e} basis[:, t] * gate_e[:, e2[t]]: (LN, T),
    (LN, E), sorted int32 e1 (T,), int32 e2 (T,) -> (LN, num_edges).
    ``e2_order``: the batch's :func:`triplet_e2_order`, kept for the
    backward."""
    order, off2 = e2_order
    return FusedTripletGateSum.apply(basis_fm, gate_e_fm, e1, e2, num_edges, order, off2)


def backward_pair(basis_fm, gate_e_fm, g, e1, e2, num_edges: int, e2_order):
    """(dB, dG) of :func:`fused_triplet_gate_sum` for the output cotangent
    ``g`` (LN, E): dB (LN, T), dG (LN, num_edges). ``e2_order``: the
    batch's :func:`triplet_e2_order`, along which the kernel sums dG."""
    order, off2 = e2_order
    return BackwardPair.apply(basis_fm, gate_e_fm, g, e1, e2, num_edges, order, off2)

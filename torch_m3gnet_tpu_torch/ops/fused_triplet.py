"""The fused three-body message stage: CUDA kernels, plain versions, autograd.

Counterpart of ``torch_m3gnet_tpu.ops.pallas_fused_triplet``. Per block the
fused three-body mode (``models/m3gnet.py``) computes

    out[:, e] = sum_{t: e1[t]=e} basis[:, t] * gate_e[:, e2[t]]      (LN,T),(LN,E) -> (LN,E)

and its VJP, itself a first-class op:

    backward_pair(basis, gate_e, g) = (dB, dG),
    dB[:, t] = g[:, e1[t]] * gate_e[:, e2[t]]                        (LN, T)
    dG[:, e] = sum_{t: e2[t]=e} g[:, e1[t]] * basis[:, t]            (LN, E)

``e1`` (the triplet's i->j edge) is int32, sorted ascending, in [0, E): the
forward kernel finds each edge's triplets by searching it. ``e2`` (the i->k
edge) is int32 in [0, E), unsorted. Padded triplets carry zero basis.

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

``LAUNCHES`` counts the calls of each op that launch its kernel (CUDA path
only).
"""

from __future__ import annotations

import torch

from torch_m3gnet_tpu_torch.ops import _cuda
from torch_m3gnet_tpu_torch.ops.segment import segment_sum_fm, take_fm

# The forward kernel is instantiated for LN = 1..16 rows (csrc/fused_triplet.cu).
KERNEL_MAX_ROWS = 16

LAUNCHES = {"fused_triplet_gate_sum": 0, "backward_pair": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check(name, e1, e2, num_edges, pairs) -> bool:
    """Validate shapes (every path); True for the CUDA path."""
    t = e1.shape[0] if e1.dim() == 1 else -1
    if e1.dim() != 1 or tuple(e2.shape) != (t,):
        raise ValueError(
            f"{name}: e1 and e2 must be 1-D of one length, got "
            f"{tuple(e1.shape)} and {tuple(e2.shape)}"
        )
    rows = pairs[0][1].shape[0] if pairs[0][1].dim() == 2 else -1
    for label, x, cols in pairs:
        want = (rows, t if cols == "T" else num_edges)
        if tuple(x.shape) != want:
            raise ValueError(f"{name}: {label} has shape {tuple(x.shape)}, expected {want}")
    return _cuda.is_cuda(name, [(label, x) for label, x, _ in pairs], [("e1", e1), ("e2", e2)])


def _forward(basis_fm, gate_e_fm, e1, e2, num_edges):
    name = "fused_triplet_gate_sum"
    if not _check(name, e1, e2, num_edges, [("basis", basis_fm, "T"), ("gate_e", gate_e_fm, "E")]):
        return fused_triplet_gate_sum_plain(basis_fm, gate_e_fm, e1, e2, num_edges)
    rows, t = basis_fm.shape
    if not 1 <= rows <= KERNEL_MAX_ROWS:
        raise ValueError(f"{name}: the CUDA kernel is built for 1..{KERNEL_MAX_ROWS} rows, got {rows}")
    out = torch.empty((rows, num_edges), dtype=torch.float32, device=basis_fm.device)
    if out.numel() == 0:  # nothing to compute: a zero-size grid is an error
        return out
    basis_fm, gate_e_fm = basis_fm.contiguous(), gate_e_fm.contiguous()
    _cuda.launch(LAUNCHES, name, "m3g_fused_triplet_gate_sum", out.device,
                 basis_fm.data_ptr(), gate_e_fm.data_ptr(), e1.data_ptr(), e2.data_ptr(),
                 out.data_ptr(), rows, num_edges, t)
    return out


def _backward(basis_fm, gate_e_fm, g, e1, e2, num_edges):
    name = "backward_pair"
    pairs = [("basis", basis_fm, "T"), ("gate_e", gate_e_fm, "E"), ("g", g, "E")]
    if not _check(name, e1, e2, num_edges, pairs):
        return backward_pair_plain(basis_fm, gate_e_fm, g, e1, e2, num_edges)
    rows, t = basis_fm.shape
    dev = basis_fm.device
    d_basis = torch.empty((rows, t), dtype=torch.float32, device=dev)
    if d_basis.numel() == 0:  # no triplets: nothing to launch
        return d_basis, torch.zeros((rows, num_edges), dtype=torch.float32, device=dev)
    d_gate = torch.empty((rows, num_edges), dtype=torch.float32, device=dev)
    basis_fm, gate_e_fm, g = basis_fm.contiguous(), gate_e_fm.contiguous(), g.contiguous()
    _cuda.launch(LAUNCHES, name, "m3g_backward_pair", dev,
                 basis_fm.data_ptr(), gate_e_fm.data_ptr(), g.data_ptr(), e1.data_ptr(),
                 e2.data_ptr(), d_basis.data_ptr(), d_gate.data_ptr(), rows, num_edges, t)
    return d_basis, d_gate


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class FusedTripletGateSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, basis_fm, gate_e_fm, e1, e2, num_edges):
        ctx.save_for_backward(basis_fm, gate_e_fm, e1, e2)
        ctx.num_edges = num_edges
        return _forward(basis_fm, gate_e_fm, e1, e2, num_edges)

    @staticmethod
    def backward(ctx, g):
        basis_fm, gate_e_fm, e1, e2 = ctx.saved_tensors
        d_basis, d_gate = backward_pair(basis_fm, gate_e_fm, g, e1, e2, ctx.num_edges)
        return d_basis, d_gate, None, None, None


class BackwardPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, basis_fm, gate_e_fm, g, e1, e2, num_edges):
        ctx.save_for_backward(basis_fm, gate_e_fm, g, e1, e2)
        ctx.num_edges = num_edges
        return _backward(basis_fm, gate_e_fm, g, e1, e2, num_edges)

    @staticmethod
    def backward(ctx, u_b, u_g):
        basis_fm, gate_e_fm, g, e1, e2 = ctx.saved_tensors
        e = ctx.num_edges
        # d/dB <u_g, dG> = g[:, e1] * u_g[:, e2] and d/dG <u_b, dB> =
        # scatter_e2(g[:, e1] * u_b): one backward_pair call with (u_b, u_g).
        g_basis, g_gate = backward_pair(u_b, u_g, g, e1, e2, e)
        g_g = None
        if ctx.needs_input_grad[2]:
            g_g = (fused_triplet_gate_sum(u_b, gate_e_fm, e1, e2, e)
                   + fused_triplet_gate_sum(basis_fm, u_g, e1, e2, e))
        return g_basis, g_gate, g_g, None, None, None


def fused_triplet_gate_sum(basis_fm, gate_e_fm, e1, e2, num_edges: int) -> torch.Tensor:
    """out[:, e] = sum_{t: e1[t]=e} basis[:, t] * gate_e[:, e2[t]]: (LN, T),
    (LN, E), sorted int32 e1 (T,), int32 e2 (T,) -> (LN, num_edges)."""
    return FusedTripletGateSum.apply(basis_fm, gate_e_fm, e1, e2, num_edges)


def backward_pair(basis_fm, gate_e_fm, g, e1, e2, num_edges: int):
    """(dB, dG) of :func:`fused_triplet_gate_sum` for the output cotangent
    ``g`` (LN, E): dB (LN, T), dG (LN, num_edges)."""
    return BackwardPair.apply(basis_fm, gate_e_fm, g, e1, e2, num_edges)

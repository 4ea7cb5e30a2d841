"""The T-scale gather of edge geometry and its transpose: CUDA kernels,
plain versions, autograd.

Counterpart of ``torch_m3gnet_tpu.ops.pallas_windowed_take``. The fused
three-body mode reads each triplet's two edges from the feature-major
(F, E) edge geometry and, on the force path, adds the gradients back:

    windowed_take_fm(data (F, E), idx (T,))         -> out[:, t] = data[:, idx[t]]
    windowed_scatter_fm(vals (F, T), idx (T,), E)   -> out[:, e] = sum_{idx[t]=e} vals[:, t]

``idx`` is int32 in [0, E) and need not be sorted (``triplet_e2`` is not).
Both ops take the **owners** of ``idx``, ``owners = (order, offsets)``:
``order`` (T,) int32, the stable permutation that sorts ``idx``, or
``None`` when ``idx`` is already sorted (the identity); ``offsets``
(E + 1,) int32, so that edge e owns ``[offsets[e], offsets[e + 1])`` of the
order. The model passes the batch's (``data.to_torch`` builds them once
per batch: the ``triplet_e1`` offsets, and the e2 order of
:func:`~torch_m3gnet_tpu_torch.ops.fused_triplet.triplet_e2_order`). The
scatter kernel sums each edge's run with one owner per edge, in order; a
CUDA call without owners builds them first (one device sort). The take
keeps them for its VJP, the scatter; the plain versions do not read them.

Each op has a hand-written CUDA kernel (``csrc/windowed_take.cu``), a plain
torch version (``*_plain``) and an ``autograd.Function``. The Function runs
the kernel on a CUDA tensor and the plain version on a CPU tensor; on CUDA
there is no fallback. The two ops are each other's transpose, so each
one's VJP is the other Function (with the same owners) and
``create_graph=True`` works to any order.

Under ``torch.func`` the Functions take their values with a leading member
axis, (K, F, ·), which folds into the rows: one launch for every member
(``ops._vmap``).

Each kernel launch adds one to the counter ``launch.<op>`` of
``utils.profiling`` (CUDA path only).
"""

from __future__ import annotations

import torch

from torch_m3gnet_tpu_torch.ops import _cuda, _vmap
from torch_m3gnet_tpu_torch.ops.fused_triplet import triplet_e2_order


def take_fm_plain(data_fm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(F, E), (T,) -> (F, T)."""
    return data_fm.index_select(1, idx)


def scatter_fm_plain(vals_fm: torch.Tensor, idx: torch.Tensor, num_edges: int) -> torch.Tensor:
    """(F, T), (T,) -> (F, num_edges)."""
    return vals_fm.new_zeros((vals_fm.shape[0], num_edges)).index_add_(1, idx, vals_fm)


def _check(name, label, x, idx, cols=None, owners=()):
    if idx.dim() != 1:
        raise ValueError(f"{name}: idx must be 1-D, got shape {tuple(idx.shape)}")
    if x.dim() not in (2, 3) or (cols is not None and x.shape[-1] != cols):
        raise ValueError(f"{name}: {label} has shape {tuple(x.shape)}, "
                         f"expected ([K,] F, {cols or 'E'})")
    return _cuda.is_cuda(name, [(label, x)], [("idx", idx), *owners])


def _check_owners(name, owners, num_idx, num_edges):
    """The owners' (order, offsets) shapes, on every path; None passes."""
    if owners is None:
        return None, None
    order, offsets = owners
    if order is not None and tuple(order.shape) != (num_idx,):
        raise ValueError(f"{name}: order has shape {tuple(order.shape)}, expected ({num_idx},)")
    if tuple(offsets.shape) != (num_edges + 1,):
        raise ValueError(f"{name}: offsets has shape {tuple(offsets.shape)}, "
                         f"expected ({num_edges + 1},)")
    return order, offsets


# The member axis folds into the rows: both ops are row-parallel, the index shared.


def _take_forward(data_fm, idx):
    cuda = _check("windowed_take_fm", "data", data_fm, idx)
    lead, (f, e), t = data_fm.shape[:-2], data_fm.shape[-2:], idx.shape[0]
    rows = data_fm.reshape(-1, e)
    if not cuda:
        return take_fm_plain(rows, idx).reshape(*lead, f, t)
    out = torch.empty((*lead, f, t), dtype=torch.float32, device=data_fm.device)
    if out.numel() == 0:  # nothing to compute: a zero-size grid is an error
        return out
    rows = rows.contiguous()
    _cuda.launch("windowed_take_fm", "m3g_windowed_take", out.device,
                 rows.data_ptr(), idx.data_ptr(), out.data_ptr(), rows.shape[0], e, t)
    return out


def _scatter_forward(vals_fm, idx, num_edges, order, offsets):
    name = "windowed_scatter_fm"
    owners = [(label, x) for label, x in (("order", order), ("offsets", offsets)) if x is not None]
    cuda = _check(name, "vals", vals_fm, idx, idx.shape[0], owners)
    lead, (f, t) = vals_fm.shape[:-2], vals_fm.shape[-2:]
    rows = vals_fm.reshape(-1, t)
    if not cuda:
        return scatter_fm_plain(rows, idx, num_edges).reshape(*lead, f, num_edges)
    if t == 0 or rows.shape[0] * num_edges == 0:  # nothing to add
        return torch.zeros((*lead, f, num_edges), dtype=torch.float32, device=vals_fm.device)
    if offsets is None:  # no owners given: the stable order of any idx
        order, offsets = triplet_e2_order(idx, num_edges)
    out = torch.empty((*lead, f, num_edges), dtype=torch.float32, device=vals_fm.device)
    rows = rows.contiguous()
    _cuda.launch(name, "m3g_windowed_scatter", out.device, rows.data_ptr(),
                 None if order is None else order.data_ptr(), offsets.data_ptr(),
                 out.data_ptr(), rows.shape[0], num_edges, t)
    return out


class WindowedTake(torch.autograd.Function):
    @staticmethod
    def forward(data_fm, idx, order, offsets):
        return _take_forward(data_fm, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        data_fm, idx, order, offsets = inputs
        ctx.save_for_backward(idx, order, offsets)
        ctx.num_edges = data_fm.shape[-1]

    @staticmethod
    def backward(ctx, g):
        idx, order, offsets = ctx.saved_tensors
        owners = None if offsets is None else (order, offsets)
        return windowed_scatter_fm(g, idx, ctx.num_edges, owners), None, None, None

    @staticmethod
    def vmap(info, in_dims, data_fm, idx, order, offsets):
        _vmap.shared_index("windowed_take_fm", in_dims, {"idx": 1, "order": 2, "offsets": 3})
        (data_fm,) = _vmap.batch_first("windowed_take_fm", in_dims[:1], (data_fm,))
        return WindowedTake.apply(data_fm, idx, order, offsets), 0


class WindowedScatter(torch.autograd.Function):
    @staticmethod
    def forward(vals_fm, idx, num_edges, order, offsets):
        return _scatter_forward(vals_fm, idx, num_edges, order, offsets)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx, _, order, offsets = inputs
        ctx.save_for_backward(idx, order, offsets)

    @staticmethod
    def backward(ctx, g):
        idx, order, offsets = ctx.saved_tensors
        owners = None if offsets is None else (order, offsets)
        return windowed_take_fm(g, idx, owners), None, None, None, None

    @staticmethod
    def vmap(info, in_dims, vals_fm, idx, num_edges, order, offsets):
        _vmap.shared_index("windowed_scatter_fm", in_dims, {"idx": 1, "order": 3, "offsets": 4})
        (vals_fm,) = _vmap.batch_first("windowed_scatter_fm", in_dims[:1], (vals_fm,))
        return WindowedScatter.apply(vals_fm, idx, num_edges, order, offsets), 0


def windowed_take_fm(data_fm: torch.Tensor, idx: torch.Tensor, owners=None) -> torch.Tensor:
    """out[:, t] = data_fm[:, idx[t]]: (F, E), int32 (T,) in [0, E) -> (F, T).
    ``owners``: idx's (order or None, offsets), kept for the VJP."""
    order, offsets = _check_owners("windowed_take_fm", owners, idx.shape[-1], data_fm.shape[-1])
    return WindowedTake.apply(data_fm, idx, order, offsets)


def windowed_scatter_fm(vals_fm: torch.Tensor, idx: torch.Tensor, num_edges: int,
                        owners=None) -> torch.Tensor:
    """out[:, e] = sum_{t: idx[t]=e} vals_fm[:, t]: (F, T) -> (F, num_edges),
    summed along ``owners`` = idx's (order or None, offsets) on CUDA."""
    order, offsets = _check_owners("windowed_scatter_fm", owners, idx.shape[-1], num_edges)
    return WindowedScatter.apply(vals_fm, idx, num_edges, order, offsets)

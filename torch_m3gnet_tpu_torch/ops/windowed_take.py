"""The T-scale gather of edge geometry and its transpose: CUDA kernels,
plain versions, autograd.

Counterpart of ``torch_m3gnet_tpu.ops.pallas_windowed_take``. The fused
three-body mode reads each triplet's two edges from the feature-major
(F, E) edge geometry and, on the force path, adds the gradients back:

    windowed_take_fm(data (F, E), idx (T,))         -> out[:, t] = data[:, idx[t]]
    windowed_scatter_fm(vals (F, T), idx (T,), E)   -> out[:, e] = sum_{idx[t]=e} vals[:, t]

``idx`` is int32 in [0, E) and need not be sorted (``triplet_e2`` is not).

Each op has a hand-written CUDA kernel (``csrc/windowed_take.cu``), a plain
torch version (``*_plain``) and an ``autograd.Function``. The Function runs
the kernel on a CUDA tensor and the plain version on a CPU tensor; on CUDA
there is no fallback. The two ops are each other's transpose, so each
one's VJP is the other Function and ``create_graph=True`` works to any
order.

``LAUNCHES`` counts the kernel launches of each op (CUDA path only).
"""

from __future__ import annotations

import torch

from torch_m3gnet_tpu_torch.ops import _cuda

LAUNCHES = {"windowed_take_fm": 0, "windowed_scatter_fm": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def take_fm_plain(data_fm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(F, E), (T,) -> (F, T)."""
    return data_fm.index_select(1, idx)


def scatter_fm_plain(vals_fm: torch.Tensor, idx: torch.Tensor, num_edges: int) -> torch.Tensor:
    """(F, T), (T,) -> (F, num_edges)."""
    return vals_fm.new_zeros((vals_fm.shape[0], num_edges)).index_add_(1, idx, vals_fm)


def _check(name, label, x, idx, cols=None):
    if idx.dim() != 1:
        raise ValueError(f"{name}: idx must be 1-D, got shape {tuple(idx.shape)}")
    if x.dim() != 2 or (cols is not None and x.shape[1] != cols):
        raise ValueError(f"{name}: {label} has shape {tuple(x.shape)}, expected (F, {cols or 'E'})")
    return _cuda.is_cuda(name, [(label, x)], [("idx", idx)])


def _take_forward(data_fm, idx):
    if not _check("windowed_take_fm", "data", data_fm, idx):
        return take_fm_plain(data_fm, idx)
    (f, e), t = data_fm.shape, idx.shape[0]
    out = torch.empty((f, t), dtype=torch.float32, device=data_fm.device)
    if out.numel() == 0:  # nothing to compute: a zero-size grid is an error
        return out
    data_fm = data_fm.contiguous()
    _cuda.launch(LAUNCHES, "windowed_take_fm", "m3g_windowed_take", out.device,
                 data_fm.data_ptr(), idx.data_ptr(), out.data_ptr(), f, e, t)
    return out


def _scatter_forward(vals_fm, idx, num_edges):
    if not _check("windowed_scatter_fm", "vals", vals_fm, idx, idx.shape[0]):
        return scatter_fm_plain(vals_fm, idx, num_edges)
    f, t = vals_fm.shape
    if t == 0 or f * num_edges == 0:  # nothing to add
        return torch.zeros((f, num_edges), dtype=torch.float32, device=vals_fm.device)
    out = torch.empty((f, num_edges), dtype=torch.float32, device=vals_fm.device)
    vals_fm = vals_fm.contiguous()
    _cuda.launch(LAUNCHES, "windowed_scatter_fm", "m3g_windowed_scatter", out.device,
                 vals_fm.data_ptr(), idx.data_ptr(), out.data_ptr(), f, num_edges, t)
    return out


class WindowedTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data_fm, idx):
        out = _take_forward(data_fm, idx)  # checks the shapes first
        ctx.save_for_backward(idx)
        ctx.num_edges = data_fm.shape[1]
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return windowed_scatter_fm(g, idx, ctx.num_edges), None


class WindowedScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals_fm, idx, num_edges):
        ctx.save_for_backward(idx)
        return _scatter_forward(vals_fm, idx, num_edges)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return windowed_take_fm(g, idx), None, None


def windowed_take_fm(data_fm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[:, t] = data_fm[:, idx[t]]: (F, E), int32 (T,) in [0, E) -> (F, T)."""
    return WindowedTake.apply(data_fm, idx)


def windowed_scatter_fm(vals_fm: torch.Tensor, idx: torch.Tensor, num_edges: int) -> torch.Tensor:
    """out[:, e] = sum_{t: idx[t]=e} vals_fm[:, t]: (F, T) -> (F, num_edges)."""
    return WindowedScatter.apply(vals_fm, idx, num_edges)

"""Segment sums and gathers in plain torch.

Counterpart of ``torch_m3gnet_tpu.ops.segment``. There these are XLA ops
with custom VJPs that make each the other's transpose; in torch,
``index_add`` and ``index_select`` already differentiate into each other to
any order, so no custom ``autograd.Function`` is needed. Indices may be
int32. On CUDA ``index_add`` accumulates with atomics, so its sums vary in
the last bits from run to run.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` (M, ...) into (num_segments, ...) buckets."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]``; its gradient is :func:`segment_sum`."""
    return x.index_select(0, idx)


def segment_sum_fm(data_fm: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Feature-major segment sum: (F, M) columns summed into (F, num_segments)."""
    out = data_fm.new_zeros((data_fm.shape[0], num_segments))
    return out.index_add(1, seg, data_fm)


def take_fm(x_fm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Feature-major column gather: (F, N)[:, idx] -> (F, E)."""
    return x_fm.index_select(1, idx)

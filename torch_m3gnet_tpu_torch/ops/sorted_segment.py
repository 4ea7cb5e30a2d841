"""The feature-major segment sum over sorted ids: CUDA kernel, plain version,
autograd.

Counterpart of ``torch_m3gnet_tpu.ops.pallas_segment`` (``sorted_segment_sum``
and ``sorted_segment_sum_any``, one function):

    sorted_segment_sum_fm(data (F, M), seg (M,), S) -> out[:, s] = sum_{seg[m]=s} data[:, m]

``seg`` is int32, sorted ascending, in [0, S). The model sends its sorted
sums here: the node aggregation and the forces by ``edge_src``, the
gather-mode triplet->edge sum by ``triplet_e1``, and the strain stress by
``edge_graph``. ``offsets`` (S + 1,), the run offsets of ``seg``
(:func:`sorted_segment_offsets`), is optional: the batch carries those of
``edge_src`` and, in the gather mode, ``triplet_e1`` (``data.to_torch``
builds them once per batch), and with them the kernel skips its own
offsets pass; the plain
version does not read them.

The op has a hand-written CUDA kernel (``csrc/sorted_segment.cu``: no
atomics, a fixed summation order, so two calls give the same bits), a plain
torch version (``*_plain``, ``index_add``) and an ``autograd.Function``. The
Function runs the kernel on a CUDA tensor and the plain version on a CPU
tensor; on CUDA there is no fallback. Its VJP is the gather ``g[:, seg]``
(``index_select``, as JAX's VJP is ``jnp.take`` outside any kernel), whose
VJP is the segment sum again, so ``create_graph=True`` works to any order
and the training step's double backward runs the kernel too.

``LAUNCHES`` counts the calls that launch the kernel (CUDA path only).
"""

from __future__ import annotations

import torch

from torch_m3gnet_tpu_torch.ops import _cuda

LAUNCHES = {"sorted_segment_sum": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sorted_segment_sum_fm_plain(data_fm: torch.Tensor, seg: torch.Tensor,
                                num_segments: int) -> torch.Tensor:
    """(F, M), (M,) -> (F, num_segments)."""
    return data_fm.new_zeros((data_fm.shape[0], num_segments)).index_add_(1, seg, data_fm)


def sorted_segment_offsets(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments + 1,) int32 on ``seg``'s device: offsets[s] = the first m
    with seg[m] >= s, so segment s owns [offsets[s], offsets[s + 1]) of the
    sorted ``seg``; what the kernel's offsets pass computes, here once per
    batch (one device search)."""
    bounds = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, bounds).to(torch.int32)


def _forward(data_fm, seg, num_segments, offsets):
    name = "sorted_segment_sum"
    if seg.dim() != 1:
        raise ValueError(f"{name}: seg must be 1-D, got shape {tuple(seg.shape)}")
    if data_fm.dim() != 2 or data_fm.shape[1] != seg.shape[0]:
        raise ValueError(
            f"{name}: data has shape {tuple(data_fm.shape)}, expected (F, {seg.shape[0]})"
        )
    indices = [("seg", seg)]
    if offsets is not None:
        if tuple(offsets.shape) != (num_segments + 1,):
            raise ValueError(f"{name}: offsets has shape {tuple(offsets.shape)}, "
                             f"expected ({num_segments + 1},)")
        indices.append(("offsets", offsets))
    if not _cuda.is_cuda(name, [("data", data_fm)], indices):
        return sorted_segment_sum_fm_plain(data_fm, seg, num_segments)
    f, m = data_fm.shape
    dev = data_fm.device
    out = torch.empty((f, num_segments), dtype=torch.float32, device=dev)
    if out.numel() == 0:  # nothing to compute: a zero-size grid is an error
        return out
    data_fm = data_fm.contiguous()
    given = offsets is not None
    if not given:
        offsets = torch.empty(num_segments + 1, dtype=torch.int32, device=dev)
    _cuda.launch(LAUNCHES, name, "m3g_sorted_segment_sum", dev, data_fm.data_ptr(),
                 seg.data_ptr(), offsets.data_ptr(), out.data_ptr(), f, m, num_segments,
                 int(given))
    return out


class SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data_fm, seg, num_segments, offsets):
        ctx.save_for_backward(seg, offsets)
        return _forward(data_fm, seg, num_segments, offsets)

    @staticmethod
    def backward(ctx, g):
        seg, offsets = ctx.saved_tensors
        return SortedTake.apply(g, seg, offsets), None, None, None


class SortedTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_fm, seg, offsets):
        ctx.save_for_backward(seg, offsets)
        ctx.num_segments = x_fm.shape[1]
        return x_fm.index_select(1, seg)

    @staticmethod
    def backward(ctx, g):
        seg, offsets = ctx.saved_tensors
        return SortedSegmentSum.apply(g, seg, ctx.num_segments, offsets), None, None


def sorted_segment_sum_fm(data_fm: torch.Tensor, seg: torch.Tensor, num_segments: int,
                          offsets: torch.Tensor | None = None) -> torch.Tensor:
    """out[:, s] = sum_{m: seg[m]=s} data_fm[:, m]: (F, M), sorted int32 (M,)
    in [0, num_segments) -> (F, num_segments). ``offsets``: seg's
    :func:`sorted_segment_offsets`, if the caller has them."""
    return SortedSegmentSum.apply(data_fm, seg, num_segments, offsets)


def sorted_take_fm(x_fm: torch.Tensor, seg: torch.Tensor,
                   offsets: torch.Tensor | None = None) -> torch.Tensor:
    """out[:, m] = x_fm[:, seg[m]], the VJP of :func:`sorted_segment_sum_fm`;
    its own VJP is that segment sum (with ``offsets``, as there)."""
    return SortedTake.apply(x_fm, seg, offsets)

"""The feature-major segment sum over sorted ids: CUDA kernel, plain version,
autograd.

Counterpart of ``torch_m3gnet_tpu.ops.pallas_segment`` (``sorted_segment_sum``
and ``sorted_segment_sum_any``, one function):

    sorted_segment_sum_fm(data (F, M), seg (M,), S) -> out[:, s] = sum_{seg[m]=s} data[:, m]

``seg`` is int32, sorted ascending, in [0, S). The model sends its sorted
sums here: the node aggregation and the forces by ``edge_src``, the
gather-mode triplet->edge sum by ``triplet_e1``, and the strain stress by
``edge_graph``. Every call takes ``offsets`` (S + 1,), the run offsets of
``seg`` (:func:`sorted_segment_offsets`), along which the kernel sums: the
batch carries those of ``edge_src`` and ``triplet_e1`` (``data.to_torch``
builds them once per batch), and ``Potential.assemble`` builds those of
``edge_graph``. The plain version does not read them.

The op has a hand-written CUDA kernel (``csrc/sorted_segment.cu``: no
atomics, a fixed summation order, so two calls give the same bits), a plain
torch version (``*_plain``, ``index_add``) and an ``autograd.Function``. The
Function runs the kernel on a CUDA tensor and the plain version on a CPU
tensor; on CUDA there is no fallback. Its VJP is the gather ``g[:, seg]``
(``index_select``, as JAX's VJP is ``jnp.take`` outside any kernel), whose
VJP is the segment sum again, so ``create_graph=True`` works to any order
and the training step's double backward runs the kernel too.

Under ``torch.func`` (``vmap``, ``grad``, ``vjp``) the Functions take
``data`` with a leading member axis, (K, F, M), which folds into the rows:
one launch for every member (``ops._vmap``).

Each call that launches the kernel adds one to the counter
``launch.sorted_segment_sum`` of ``utils.profiling`` (CUDA path only).
"""

from __future__ import annotations

import torch

from torch_m3gnet_tpu_torch.ops import _cuda, _vmap


def sorted_segment_sum_fm_plain(data_fm: torch.Tensor, seg: torch.Tensor,
                                num_segments: int) -> torch.Tensor:
    """(F, M), (M,) -> (F, num_segments)."""
    return data_fm.new_zeros((data_fm.shape[0], num_segments)).index_add_(1, seg, data_fm)


def sorted_segment_offsets(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments + 1,) int32 on ``seg``'s device: offsets[s] = the first m
    with seg[m] >= s, so segment s owns [offsets[s], offsets[s + 1]) of the
    sorted ``seg``. One device search; the one function that makes the
    sorted ops' run offsets (``data.to_torch`` once per batch,
    ``Potential.assemble`` once per request for the strain stress)."""
    bounds = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, bounds, out_int32=True)


def _forward(data_fm, seg, num_segments, offsets):
    name = "sorted_segment_sum"
    if seg.dim() != 1:
        raise ValueError(f"{name}: seg must be 1-D, got shape {tuple(seg.shape)}")
    if data_fm.dim() not in (2, 3) or data_fm.shape[-1] != seg.shape[0]:
        raise ValueError(
            f"{name}: data has shape {tuple(data_fm.shape)}, expected ([K,] F, {seg.shape[0]})"
        )
    _cuda.check_index(name, "offsets", offsets, num_segments + 1)
    # The member axis folds into the rows: the sum is row-parallel, the index shared.
    lead, (f, m) = data_fm.shape[:-2], data_fm.shape[-2:]
    rows = data_fm.reshape(-1, m)
    if not _cuda.is_cuda(name, [("data", data_fm)], [("seg", seg), ("offsets", offsets)]):
        return sorted_segment_sum_fm_plain(rows, seg, num_segments).reshape(*lead, f, num_segments)
    dev = data_fm.device
    out = torch.empty((*lead, f, num_segments), dtype=torch.float32, device=dev)
    if out.numel() == 0:  # nothing to compute: a zero-size grid is an error
        return out
    rows = rows.contiguous()
    # The kernel tiles the rows as for one member's f, so that each member
    # is summed in the order of a call on its own.
    _cuda.launch(name, "m3g_sorted_segment_sum", dev, rows.data_ptr(), offsets.data_ptr(),
                 out.data_ptr(), rows.shape[0], m, num_segments, f)
    return out


class SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(data_fm, seg, num_segments, offsets):
        return _forward(data_fm, seg, num_segments, offsets)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, seg, _, offsets = inputs
        ctx.save_for_backward(seg, offsets)

    @staticmethod
    def backward(ctx, g):
        seg, offsets = ctx.saved_tensors
        return SortedTake.apply(g, seg, offsets), None, None, None

    @staticmethod
    def vmap(info, in_dims, data_fm, seg, num_segments, offsets):
        _vmap.shared_index("sorted_segment_sum", in_dims, {"seg": 1, "offsets": 3})
        (data_fm,) = _vmap.batch_first("sorted_segment_sum", in_dims[:1], (data_fm,))
        return SortedSegmentSum.apply(data_fm, seg, num_segments, offsets), 0


class SortedTake(torch.autograd.Function):
    @staticmethod
    def forward(x_fm, seg, offsets):
        if x_fm.dim() not in (2, 3):
            raise ValueError(f"sorted_take: x has shape {tuple(x_fm.shape)}, expected ([K,] F, S)")
        _cuda.check_index("sorted_take", "offsets", offsets, x_fm.shape[-1] + 1)
        return x_fm.index_select(-1, seg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x_fm, seg, offsets = inputs
        ctx.save_for_backward(seg, offsets)
        ctx.num_segments = x_fm.shape[-1]

    @staticmethod
    def backward(ctx, g):
        seg, offsets = ctx.saved_tensors
        return SortedSegmentSum.apply(g, seg, ctx.num_segments, offsets), None, None

    @staticmethod
    def vmap(info, in_dims, x_fm, seg, offsets):
        _vmap.shared_index("sorted_take", in_dims, {"seg": 1, "offsets": 2})
        (x_fm,) = _vmap.batch_first("sorted_take", in_dims[:1], (x_fm,))
        return SortedTake.apply(x_fm, seg, offsets), 0


def sorted_segment_sum_fm(data_fm: torch.Tensor, seg: torch.Tensor, num_segments: int,
                          offsets: torch.Tensor) -> torch.Tensor:
    """out[..., s] = sum_{m: seg[m]=s} data_fm[..., m]: ([K,] F, M), sorted
    int32 (M,) in [0, num_segments) -> ([K,] F, num_segments), along seg's
    :func:`sorted_segment_offsets` ``offsets``."""
    return SortedSegmentSum.apply(data_fm, seg, num_segments, offsets)


def sorted_take_fm(x_fm: torch.Tensor, seg: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """out[:, m] = x_fm[:, seg[m]], the VJP of :func:`sorted_segment_sum_fm`;
    its own VJP is that segment sum (along ``offsets``, as there)."""
    return SortedTake.apply(x_fm, seg, offsets)

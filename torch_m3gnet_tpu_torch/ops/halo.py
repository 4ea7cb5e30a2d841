"""Collectives of graph parallelism: the boundary halo exchange, the legacy
all-gather of node columns, and the all-reduce, each differentiable to any
order.

Counterpart of ``torch_m3gnet_tpu.ops.halo`` (``halo_exchange_fm``; the
port has one layout, node columns ``(F, nps)``) on ``torch.distributed``.
A shard reads remote node rows only at the destinations of its cut edges;
the partitioner (``parallel.graph_shard.partition_graph``) records which:

- ``offsets`` (a tuple): the ring offsets with traffic; shard ``j`` sends
  its block ``i`` to shard ``(j + offsets[i]) % S``;
- ``send_idx`` ``(n_offsets * Hp,)``: the local rows to send, one block of
  ``Hp`` rows per offset (padded slots point at row 0 and are never read);
- ``recv_idx`` ``(H,)``: for each halo slot, the row of the received
  ``(n_offsets * Hp,)`` blocks that holds it.

The exchange gathers the send rows, moves every block in ONE
``all_to_all_single`` with uneven splits (``Hp`` rows to each peer
``(rank + d) % S``, none to the other ranks), gathers the halo slots from
what came back and appends them to the local columns: ``(F, nps + H)``,
addressed by extended-local ids. Communication is ``n_offsets * Hp`` rows a
shard, the boundary's size. JAX runs one ``ppermute`` per offset; one
uneven all-to-all does the same on NCCL and on gloo, which has no
point-to-point path for CUDA tensors.

Differentiation: the collectives are ``torch.autograd.Function`` s whose
backward is again one of them (an all-to-all's is the all-to-all with its
splits swapped, an all-reduce's the all-reduce, an all-gather's the
all-reduce of the cotangent and this rank's slice of it), and everything
around them is ``index_select``, ``index_add``, slicing and ``cat``. So the
exchange's VJP is the reverse exchange with an ``index_add`` into the
owner rows, and a loss on forces differentiates through it twice.

Conventions for the gradients of a loss that every rank computes alike (the
gp loss): each collective's backward is its exact adjoint over all ranks,
so after every rank backpropagates its copy of the loss the weights'
gradient of the loss is the MEAN over ranks of the local gradients
(``parallel.graph_shard`` reduces them so).

The ranks' collectives must run in one order on every rank: every rank
runs the same program on its shard, forward and backward (also where
``remat_triplets`` reruns a stage's exchange in the backward pass).

Rows move in their own dtype: under ``compute_dtype="bfloat16"`` block 0
exchanges the bf16 node features, as JAX's ``gather_nodes_fm(v_fm)``
does. gloo (which the CPU tests run) and NCCL both take bf16 in
``all_to_all_single``, ``all_gather`` and ``all_reduce``, so no f32 detour
is needed.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


class _AllReduce(torch.autograd.Function):
    """Sum over the group; its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 with uneven splits; the adjoint is
    the all-to-all with the splits swapped."""

    @staticmethod
    def forward(ctx, x, in_splits, out_splits, group):
        ctx.splits, ctx.group = (in_splits, out_splits), group
        out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(out_splits), list(in_splits),
                               group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        in_splits, out_splits = ctx.splits
        return _AllToAll.apply(g, out_splits, in_splits, ctx.group), None, None, None


class _AllGather(torch.autograd.Function):
    """Every rank's rows (dim 0), in rank order; the adjoint sums the
    cotangent over the group and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        lo = dist.get_rank(ctx.group) * ctx.rows
        return _AllReduce.apply(g, ctx.group)[lo: lo + ctx.rows], None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` on every rank (differentiable)."""
    return _AllReduce.apply(x, group)


def _ring_shift(rows: torch.Tensor, offsets: Sequence[int], group,
                reverse: bool = False) -> torch.Tensor:
    """Send block ``i`` of ``rows`` (``n_offsets`` blocks of equal length,
    in offset order) to rank ``(rank + offsets[i]) % S`` and return the
    blocks received, block ``i`` from rank ``(rank - offsets[i]) % S``;
    ``reverse`` runs the ring the other way (the adjoint)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    sign = -1 if reverse else 1
    dest = [(rank + sign * d) % size for d in offsets]
    srcs = [(rank - sign * d) % size for d in offsets]
    blocks = rows.chunk(len(offsets))
    hp = blocks[0].shape[0]
    # all_to_all_single lays both buffers out in rank order
    send = torch.cat([blocks[i] for i in sorted(range(len(dest)), key=dest.__getitem__)])
    in_splits = [hp if q in dest else 0 for q in range(size)]
    out_splits = [hp if q in srcs else 0 for q in range(size)]
    got = _AllToAll.apply(send, in_splits, out_splits, group).chunk(len(offsets))
    by_rank = {q: j for j, q in enumerate(sorted(srcs))}
    return torch.cat([got[by_rank[q]] for q in srcs])


def halo_exchange_fm(x_fm: torch.Tensor, send_idx: torch.Tensor, recv_idx: torch.Tensor,
                     offsets: Sequence[int], group) -> torch.Tensor:
    """``cat([x_fm, halo columns], 1)``: (F, nps) -> (F, nps + H), the halo
    slots in ``recv_idx`` order. With no offset (no cut edge) the halo
    columns are zero: no edge reads them."""
    if not offsets:
        return torch.cat([x_fm, x_fm.new_zeros(x_fm.shape[0], recv_idx.shape[0])], 1)
    recv = _ring_shift(x_fm.index_select(1, send_idx).t(), offsets, group)
    return torch.cat([x_fm, recv.index_select(0, recv_idx).t()], 1)


def halo_reverse_fm(y_fm: torch.Tensor, send_idx: torch.Tensor, recv_idx: torch.Tensor,
                    offsets: Sequence[int], group) -> torch.Tensor:
    """The adjoint of :func:`halo_exchange_fm`: (F, nps + H) -> (F, nps);
    each halo column goes back to its owner and is summed into the row it
    came from."""
    nps = y_fm.shape[1] - recv_idx.shape[0]
    local, halo = y_fm[:, :nps], y_fm[:, nps:]
    if not offsets:
        return local
    rows = halo.new_zeros(send_idx.shape[0], halo.shape[0]).index_add(0, recv_idx, halo.t())
    back = _ring_shift(rows, offsets, group, reverse=True)
    return local.index_add(1, send_idx, back.t())


def all_gather_fm(x_fm: torch.Tensor, group) -> torch.Tensor:
    """Every rank's node columns, in rank order: (F, nps) -> (F, S * nps)."""
    return _AllGather.apply(x_fm.t(), group).t()


def reduce_scatter_fm(y_fm: torch.Tensor, group) -> torch.Tensor:
    """The adjoint of :func:`all_gather_fm`: (F, S * nps) -> (F, nps), the
    sum over ranks of this rank's columns (an all-reduce and a slice: one
    collective that every backend has for every dtype)."""
    nps = y_fm.shape[1] // dist.get_world_size(group)
    lo = dist.get_rank(group) * nps
    return all_reduce(y_fm, group)[:, lo: lo + nps]


def extended_nodes(graph, group) -> int:
    """The columns that a shard's destination ids address: nps + H with a
    halo plan, S * nps without (the all-gather partition's global ids)."""
    if graph.halo_send_idx is not None:
        return graph.num_nodes + graph.halo_recv_idx.shape[0]
    return graph.num_nodes * dist.get_world_size(group)


def extend_nodes_fm(x_fm: torch.Tensor, graph, group) -> torch.Tensor:
    """A shard's node columns made addressable by its destination ids: the
    halo exchange with a plan, the all-gather without."""
    if graph.halo_send_idx is not None:
        return halo_exchange_fm(x_fm, graph.halo_send_idx, graph.halo_recv_idx,
                                graph.halo_offsets, group)
    return all_gather_fm(x_fm, group)


def reduce_extended_fm(y_fm: torch.Tensor, graph, group) -> torch.Tensor:
    """The adjoint of :func:`extend_nodes_fm`: sums by destination id come
    home to the owners' rows."""
    if graph.halo_send_idx is not None:
        return halo_reverse_fm(y_fm, graph.halo_send_idx, graph.halo_recv_idx,
                               graph.halo_offsets, group)
    return reduce_scatter_fm(y_fm, group)

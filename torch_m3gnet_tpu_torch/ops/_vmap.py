"""The member axis of the kernel Functions, and their ``torch.func.vmap`` rules.

Every kernel Function of the port takes each float operand either as (rows,
cols), shared by every member, or as (K, rows, cols), one slab per member:
one optional leading **member** axis. The index (ids, offsets, orders) is
never batched: the members share one graph. That is what JAX's ``vmap`` of a
``pallas_call`` does: the kernel gets a grid axis over the batch, and an
operand that is not batched is read by every step of it.

A Function's ``vmap`` staticmethod moves vmap's batch dim of each batched
operand to the front (:func:`batch_first`) and calls the Function again: one
call, whatever the batch. One vmap level: an operand that already has a
member axis under vmap raises. Each backward is built from the same
Functions, so ``torch.func.vmap`` of a backward (batched cotangents with
shared saved tensors, a Hessian's rows) reaches the same rules; a gradient
for an operand that was shared is summed over the members (:func:`reduce_to`).
"""

from __future__ import annotations

import torch


def shared_index(name: str, in_dims, labels: dict[str, int]) -> None:
    """Raise ``ValueError`` if vmap batches any index (``labels``: name ->
    argument position): the members share one graph."""
    for label, pos in labels.items():
        if in_dims[pos] is not None:
            raise ValueError(f"{name}: {label} is batched under vmap; the members share one "
                             f"graph, so the index must be shared")


def batch_first(name: str, in_dims, xs) -> list[torch.Tensor]:
    """The float operands ``xs`` (with their ``in_dims``) as the Function
    takes them under vmap: a batched one as (K, rows, cols), vmap's batch
    dim in front; a shared one as it is, (rows, cols)."""
    out = []
    for x, d in zip(xs, in_dims):
        if x.dim() - (d is not None) != 2:
            raise ValueError(f"{name}: under vmap each float operand must be (rows, cols), got "
                             f"{x.dim() - (d is not None)} dims: the kernels take one vmap level")
        out.append(x if d is None else x.movedim(d, 0))
    return out


def members(name: str, pairs) -> int | None:
    """K of the (label, tensor) operands, each (rows, cols) or (K, rows,
    cols); None when none has the member axis. Raise ``ValueError`` on
    another rank or on two K."""
    ks = set()
    for label, x in pairs:
        if x.dim() not in (2, 3):
            raise ValueError(f"{name}: {label} must be (rows, cols) or (K, rows, cols), "
                             f"got {tuple(x.shape)}")
        if x.dim() == 3:
            ks.add(x.shape[0])
    if len(ks) > 1:
        shapes = ", ".join(f"{label} {tuple(x.shape)}" for label, x in pairs)
        raise ValueError(f"{name}: the operands have different member counts ({shapes})")
    return ks.pop() if ks else None


def per_member(fn, k: int | None, floats, rest):
    """``fn(*member floats, *rest)`` for each of ``k`` members, stacked
    (``fn`` may return a tuple); ``fn`` itself for ``k`` None. The CPU path
    of the kernel Functions (their plain versions); on CUDA every kernel
    takes the member axis in one launch (:func:`kernel_operand`)."""
    if k is None:
        return fn(*floats, *rest)
    outs = [fn(*(x[i] if x.dim() == 3 else x for x in floats), *rest) for i in range(k)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(p) for p in zip(*outs))
    return torch.stack(outs)


def kernel_operand(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(contiguous ``x``, member stride in elements) for a kernel with a
    member axis: a shared operand once with stride 0, a batched one as its
    (K, rows, cols) slabs (no copy when it is contiguous)."""
    x = x.contiguous()
    return x, (x.shape[1] * x.shape[2] if x.dim() == 3 else 0)


def reduce_to(x: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor | None:
    """A gradient with the member axis, summed over it where its operand
    ``like`` was shared."""
    if x is None or x.dim() == like.dim():
        return x
    return x.sum(0)

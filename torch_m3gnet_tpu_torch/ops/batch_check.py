"""The range and order checks of a batch's indices, on the device the indices
were copied to: CUDA kernel and plain version.

``data.to_torch`` copies a host batch to its device and checks its indices
there, before any kernel reads them: the kernels do not check bounds (an
index out of range reads or writes out of bounds, an unsorted one gives
wrong sums). A check is a list of rules, one index array each::

    IndexRule(name, index (L,), bound, sorted, noun)

Every value of ``index`` must lie in [0, ``bound``), and where ``sorted``
each must be <= the next. The check computes one word: bit 2 i is set where
rule i's array is not sorted, bit 2 i + 1 where a value lies outside its
bound. The lowest set bit is the first rule that fails, order before range
and the rules in their list's order; :func:`check_indices` raises its
``ValueError``. Every element is read, in the dtype the caller gave (int32
or int64; other integer types are widened to int64 first), so no value
wraps into range before it is checked.

The op has a hand-written CUDA kernel (``csrc/batch_check.cu``: every array
in one launch, one pass, 16-byte loads; ``m3g_check_batch_index``, which
zeroes the word with a memset on the stream before the launch) and a
plain torch version (:func:`index_word_plain`). A CPU index takes the plain
version, a CUDA index the kernel; on CUDA there is no fallback. The JAX
package checks on the host and has no kernel for this.

Each launch adds one to the counter ``launch.batch_check`` of
``utils.profiling`` (CUDA path only).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from torch_m3gnet_tpu_torch.ops import _cuda

# Arrays of one kernel launch at most (the batch has eight index arrays).
MAX_RULES = 8


class IndexRule(NamedTuple):
    name: str
    index: torch.Tensor | None  # 1-D; None: absent, nothing to check
    bound: int
    sorted: bool
    noun: str  # what one value names: "a node index", "an edge index", ...


def _validate(rules) -> None:
    for r in rules:
        if r.index is not None and (r.index.dtype.is_floating_point
                                    or r.index.dtype.is_complex or r.index.dtype == torch.bool):
            raise TypeError(f"{r.name} must hold integers, got {r.index.dtype}")


def index_word_plain(rules) -> int:
    """The check's word, computed with torch ops (any device)."""
    word = 0
    for i, r in enumerate(rules):
        x = r.index
        if x is None or x.numel() == 0:
            continue
        x = x.reshape(-1)
        if r.sorted and bool((x[1:] < x[:-1]).any()):
            word |= 1 << (2 * i)
        if bool(x.min() < 0) or bool(x.max() >= r.bound):
            word |= 1 << (2 * i + 1)
    return word


def index_word_device(rules) -> torch.Tensor:
    """Launch the kernel over CUDA ``rules``; the word as a (1,) int32 tensor
    on their device, not read back (the caller reads it)."""
    if len(rules) > MAX_RULES:  # the word's bits and the kernel's table
        raise ValueError(f"batch_check: {len(rules)} rules, at most {MAX_RULES}")
    present = [(i, r) for i, r in enumerate(rules) if r.index is not None]
    dev = present[0][1].index.device if present else None
    arrays, table = [], []
    for i, r in present:
        if r.index.device != dev:
            raise ValueError(f"batch_check: {r.name} is on {r.index.device}, expected {dev}")
        x = r.index
        if x.dtype not in (torch.int32, torch.int64):
            x = x.to(torch.int64)  # widening: no value changes
        if x.dim() != 1 or not x.is_contiguous() or x.data_ptr() % 16:
            # a fresh copy: 1-D, contiguous, and aligned for the 16-byte loads
            x = x.reshape(-1).clone(memory_format=torch.contiguous_format)
        arrays.append(x)  # held until the launch has read the table
        table += [x.data_ptr(), x.numel(), r.bound, x.element_size(),
                  (1 << 2 * i) if r.sorted else 0, 1 << (2 * i + 1)]
    word = torch.empty(1, dtype=torch.int32, device=dev)  # zeroed by the entry, on the stream
    rows = (ctypes.c_longlong * len(table))(*table)
    _cuda.launch("batch_check", "m3g_check_batch_index", dev, ctypes.addressof(rows),
                 len(arrays), word.data_ptr())
    return word


def index_word(rules) -> int:
    """The check's word: the kernel for CUDA indices (one launch, one 4-byte
    read), the plain version for CPU ones."""
    rules = list(rules)
    _validate(rules)
    devices = {r.index.device.type for r in rules if r.index is not None}
    if not devices:
        return 0
    if devices == {"cpu"}:
        return index_word_plain(rules)
    if devices != {"cuda"}:
        raise ValueError(f"batch_check: no kernel for devices {sorted(devices)}")
    return int(index_word_device(rules).item())


def _message(rule: IndexRule, order: bool) -> str:
    if order:
        return f"{rule.name} must be sorted ascending"
    return f"{rule.name} holds {rule.noun} outside [0, {rule.bound})"


def check_indices(rules) -> None:
    """Raise the ``ValueError`` of the first rule that ``rules`` break."""
    rules = list(rules)
    word = index_word(rules)
    if word:
        bit = (word & -word).bit_length() - 1
        raise ValueError(_message(rules[bit // 2], order=bit % 2 == 0))

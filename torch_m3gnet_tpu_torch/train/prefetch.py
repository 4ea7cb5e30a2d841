"""Device prefetch of training batches: host assembly and the copy to the
card overlap the step that runs on it.

The CUDA counterpart of ``torch_m3gnet_tpu.train.prefetch``. A producer
thread takes each host batch from the epoch's iterator (padding and
concatenation run there), runs ``to_torch``'s host checks, copies the
arrays from pinned memory with ``non_blocking=True`` on a side
``torch.cuda.Stream`` and builds there the kernel index that the model's
mode reads (``M3GNet.batch_index``). It records an event after that work;
the consumer's stream waits on the event before it hands the batch on, and
each tensor is marked with ``record_stream`` for the consumer's stream, so
the caching allocator reuses none of its memory until the consumer's work
on it is done.

Under data or graph parallelism each rank prefetches its own row of each
batch to its own card (``parallel.dp.ParallelTrainer``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Iterator

import torch

from torch_m3gnet_tpu_torch.data.graph import GraphBatch, to_torch
from torch_m3gnet_tpu_torch.data.streaming import background
from torch_m3gnet_tpu_torch.models.m3gnet import resolve_device


def _to_card(batch, device, stream, consumer, index) -> tuple[GraphBatch, torch.cuda.Event]:
    """Check ``batch`` on the host, copy it from pinned memory on ``stream``
    and build its index there; returns the card batch and the event that
    ends that work."""
    host = to_torch(batch, "cpu", index=())  # the host checks; int32 indices
    with torch.cuda.stream(stream):
        moved = {f.name: getattr(host, f.name).pin_memory().to(device, non_blocking=True)
                 for f in dataclasses.fields(GraphBatch)
                 if isinstance(getattr(host, f.name), torch.Tensor)}
        out = to_torch(host.replace(**moved), device, index=index)
        event = torch.cuda.Event()
        event.record(stream)
    for f in dataclasses.fields(GraphBatch):
        t = getattr(out, f.name)
        if isinstance(t, torch.Tensor):
            t.record_stream(consumer)
    return out, event


def device_prefetch(
    batches: Iterable, size: int = 2, device=None, index: tuple[str, ...] = ()
) -> Iterator[GraphBatch]:
    """Yield the batches of ``batches`` on ``device`` (default: the card),
    prepared up to ``size`` ahead in a producer thread, each with the parts
    ``index`` of its kernel index (``data.graph.BATCH_INDEX_FIELDS``).

    ``size=0`` is plain iteration: the batches pass through untouched. An
    exception of the producer re-raises in the consumer. On the CPU the
    producer runs ``to_torch`` ahead of the step, with no stream.
    """
    if size <= 0:
        yield from batches
        return
    device = resolve_device(device)
    if device.type == "cuda":
        stream = torch.cuda.Stream(device)
        consumer = torch.cuda.current_stream(device)

        def prepared():
            for b in batches:
                yield _to_card(b, device, stream, consumer, index)
    else:
        def prepared():
            for b in batches:
                yield to_torch(b, device, index=index), None

    with contextlib.closing(background(prepared(), size)) as it:
        for batch, event in it:
            if event is not None:
                consumer.wait_event(event)
            yield batch

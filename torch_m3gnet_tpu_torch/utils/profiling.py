"""Profiling helpers (counterpart of ``torch_m3gnet_tpu.utils.profiling``):
a step counter of edges+triplets/s (the bench metric) and graphs/s, and a
``torch.profiler`` trace context whose trace TensorBoard's profiler plugin
or Perfetto opens.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass


@dataclass
class Throughput:
    """Running edges+triplets/sec (and graphs/sec) counter."""

    items: int = 0
    graphs: int = 0
    seconds: float = 0.0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, batch) -> None:
        """Account one completed step on ``batch``. The device runs ahead of
        the host: call ``torch.cuda.synchronize()`` before this, or the time
        is that of the launches. The masks may be numpy arrays or tensors."""
        if self._t0 is None:
            return
        self.seconds += time.perf_counter() - self._t0
        self._t0 = None
        self.items += int(batch.edge_mask.sum()) + int(batch.triplet_mask.sum())
        self.graphs += int(batch.graph_mask.sum())

    @property
    def items_per_sec(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    @property
    def graphs_per_sec(self) -> float:
        return self.graphs / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block (host ops, and the card's kernels where CUDA is
    available) and write its Chrome trace, ``<log_dir>/*.pt.trace.json``,
    which TensorBoard's profiler plugin and Perfetto open."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield

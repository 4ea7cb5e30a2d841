"""The port's spans and counters, and a ``torch.profiler`` trace context.

- :func:`span` names a stretch of host work (``m3gnet.<part>``) in the
  profiler's own timeline, where it shares its clock with the device
  records. It records only while a torch profiler runs (the benchmark's
  traced window, :func:`device_trace`); otherwise it returns one shared
  null context and costs one check of the profiler's state. A span never
  synchronises the device.
- :func:`count` adds to one registry of named integers, always on: the
  kernel launches of the hand kernels (``launch.<op>``, bumped by
  ``ops._cuda.launch``) and the host bytes that ``data.to_torch`` converts
  (``to_torch.host_bytes``, ``to_torch.host_batches``).
- :func:`device_trace` writes a Chrome trace that TensorBoard's profiler
  plugin or Perfetto opens; it carries the spans.
"""

from __future__ import annotations

import contextlib
import threading

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_NULL = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}
_LOCK = threading.Lock()  # the prefetch producer and the autograd engine count too


def span(name: str):
    """A context that records ``name`` in the running profiler's timeline;
    the shared null context when no profiler runs."""
    return record_function(name) if _profiler_enabled() else _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> dict[str, int]:
    """A copy of every counter."""
    with _LOCK:
        return dict(_COUNTS)


def reset_counts(prefix: str = "") -> None:
    """Drop the counters whose name starts with ``prefix`` (all by default)."""
    with _LOCK:
        for name in [k for k in _COUNTS if k.startswith(prefix)]:
            del _COUNTS[name]


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

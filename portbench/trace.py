"""The traced run: torch.profiler over a few spans of the cell's own loop,
reduced to plain records that the per-layer readers take apart.

The harness's own spans (``record_function``) mark each request, step or
chunk (``portbench.span``) and the calls inside it that the benchmark makes
into the program (``portbench.to_torch``). From the profiler it keeps:

- ``spans``: the benchmark's spans, host clock;
- ``launches``: the host's kernel-launch calls into CUDA (``cudaLaunchKernel``
  and its kin), each with its correlation id;
- ``device``: the device's kernels, copies and fills, each with the
  correlation id of the launch that made it.

torch.profiler drops some device records, more at a window's ends: the
window is padded with host time on both sides, and a reader that needs a
span's every kernel takes only the spans whose every launch has its record
(:meth:`Trace.complete`).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

PAD_S = 0.05
SPAN = "portbench.span"
LAUNCH_WORDS = ("LaunchKernel", "LaunchCooperativeKernel")
SHORT_GAP_NS = 5000


@dataclass
class Record:
    kind: str  # span | op | launch | kernel | memcpy | memset
    name: str
    start: int  # ns
    end: int  # ns
    corr: int = 0
    link: int = 0  # the linked correlation id of a device record


@dataclass
class Trace:
    records: list = field(default_factory=list)
    # per span (in order): what the benchmark knows of its work, e.g. the
    # batch's shapes, atoms and steps (filled by the traffic kind)
    work: list = field(default_factory=list)
    # fills ``work`` where that needs the device (called after the peak
    # memory of the run is read)
    finish: object = None

    def of(self, kind: str, name: str | None = None) -> list:
        return [r for r in self.records if r.kind == kind and (name is None or r.name == name)]

    def spans(self, name: str = SPAN) -> list:
        return sorted(self.of("span", name), key=lambda r: r.start)

    def window(self) -> tuple[int, int]:
        spans = self.spans()
        return spans[0].start, spans[-1].end

    def launches_in(self, span: Record) -> list:
        return [r for r in self.of("launch") if span.start <= r.start <= span.end]

    def device_by_corr(self) -> dict:
        """Device records by the correlation id of their launch (kineto gives
        it as a device record's own or as its linked id)."""
        launches = {r.corr for r in self.of("launch")}
        out = {}
        for r in self.records:
            if r.kind in ("kernel", "memcpy", "memset"):
                out[r.corr if r.corr in launches else r.link] = r
        return out

    def complete(self) -> list:
        """(span index, span, [device kernel records in launch order]) of the
        spans whose every kernel launch has its device record."""
        dev = self.device_by_corr()
        out = []
        for i, span in enumerate(self.spans()):
            launches = sorted(self.launches_in(span), key=lambda r: r.start)
            kernels = [dev.get(r.corr) for r in launches]
            if launches and all(k is not None for k in kernels):
                out.append((i, span, kernels))
        return out

    def busy(self, t0: int, t1: int) -> float:
        """Seconds in [t0, t1] in which the device ran anything (the union
        of its records' intervals)."""
        ivals = sorted((max(r.start, t0), min(r.end, t1)) for r in self.records
                       if r.kind in ("kernel", "memcpy", "memset") and r.end > t0 and r.start < t1)
        total, cur_s, cur_e = 0, None, None
        for s, e in ivals:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e9

    def gaps(self, t0: int, t1: int) -> list:
        """(start, end) of the device's idle intervals in [t0, t1]."""
        ivals = sorted((r.start, r.end) for r in self.records
                       if r.kind in ("kernel", "memcpy", "memset") and r.end > t0 and r.start < t1)
        out, cur = [], t0
        for s, e in ivals:
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if cur < t1:
            out.append((cur, t1))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's idle
        gaps summed by the innermost host operation running at their middle
        (gaps under ``SHORT_GAP_NS`` summed as one entry)."""
        t0, t1 = self.window()
        by_op: dict = {}
        for r in self.records:
            if r.kind in ("kernel", "memcpy", "memset") and r.end > t0 and r.start < t1:
                by_op[r.name] = by_op.get(r.name, 0.0) + (min(r.end, t1) - max(r.start, t0)) / 1e9
        host = sorted((r for r in self.records if r.kind in ("op", "span", "launch")),
                      key=lambda r: r.start)
        starts = [r.start for r in host]
        by_host: dict = {}
        for s, e in self.gaps(t0, t1):
            name = f"gaps under {SHORT_GAP_NS // 1000} us"
            if e - s >= SHORT_GAP_NS:
                mid, i = (s + e) // 2, bisect.bisect_right(starts, (s + e) // 2) - 1
                while i >= 0 and host[i].end < mid:  # nested: the latest start that covers
                    i -= 1
                name = host[i].name if i >= 0 else "host: none"
            by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e9
        rank = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def _kind(event) -> str | None:
    """span, launch, op (host) or kernel, memcpy, memset (device); None for
    the device-side copy of an annotation."""
    name = event.name()
    if "CUDA" in str(event.device_type()):
        if event.is_user_annotation():
            return None
        if name.startswith("Memcpy"):
            return "memcpy"
        return "memset" if name.startswith("Memset") else "kernel"
    if event.is_user_annotation():
        return "span"
    return "launch" if any(w in name for w in LAUNCH_WORDS) else "op"


def records_of(prof) -> list:
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is None:
            continue
        start = int(e.start_ns())
        out.append(Record(kind, e.name(), start, start + int(e.duration_ns()),
                          int(e.correlation_id()), int(e.linked_correlation_id())))
    return out


@contextlib.contextmanager
def profiled(device_type: str):
    """Profile the block (CPU ops and, on a card, its device), padded with
    host time on both sides; yields a list that receives the records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    records: list = []
    with profile(activities=acts) as prof:
        time.sleep(PAD_S)
        yield records
        if device_type == "cuda":
            torch.cuda.synchronize()
        time.sleep(PAD_S)
    records.extend(records_of(prof))


def span():
    """The benchmark's span around one request, step or chunk."""
    from torch.profiler import record_function

    return record_function(SPAN)

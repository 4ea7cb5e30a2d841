"""What the per-layer readers take from the program's own spans and
counters.

The program (``torch_m3gnet_tpu_torch.utils.profiling``) records spans
named ``m3gnet.<part>`` into the profiler's timeline while it runs, nested
inside the benchmark's spans on the same host clock, and keeps a registry
of counters (``counts()``). A program without them (an older checkout)
records none: every function here then returns nothing.

Each function averages over the traced requests, steps or chunks (the
benchmark's ``portbench.span``) and reads only on a card: on the CPU the
profile has no device records, and the readers stay silent there.
"""

from __future__ import annotations


def within(trace, name: str) -> list:
    """Per traced request, in order: the program spans ``name`` inside it."""
    spans = trace.of("span", name)
    return [[s for s in spans if req.start <= s.start and s.end <= req.end]
            for req in trace.spans()]


def host_ms(trace, ctx, name: str) -> float | None:
    """Host milliseconds of the spans ``name`` per traced request."""
    per = within(trace, name)
    if ctx.device != "cuda" or not any(per):
        return None
    return sum(s.end - s.start for group in per for s in group) / len(per) / 1e6


def device_ms(trace, ctx, name: str) -> float | None:
    """Device milliseconds of the records of the kernel launches inside the
    spans ``name``, per traced request, over the requests whose every such
    launch has its device record (the rule of ``Trace.complete``)."""
    if ctx.device != "cuda":
        return None
    dev = trace.device_by_corr()
    totals = []
    for group in within(trace, name):
        records = [dev.get(r.corr) for s in group for r in trace.launches_in(s)]
        if records and all(r is not None for r in records):
            totals.append(sum(r.end - r.start for r in records))
    return sum(totals) / len(totals) / 1e6 if totals else None


def counter(ctx, name: str) -> int | None:
    """The program's counter ``name`` (None where the program keeps none)."""
    if ctx.device != "cuda":
        return None
    from torch_m3gnet_tpu_torch.utils import profiling

    counts = getattr(profiling, "counts", None)
    return None if counts is None else counts().get(name)

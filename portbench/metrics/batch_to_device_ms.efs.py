"""Milliseconds of ``to_torch`` per E/F/S request: the benchmark's host span
around the call (the host checks, the copies and the kernel index), with
the device synchronised at its end in the traced run only, averaged."""

TO_TORCH = "portbench.to_torch"


def read(trace, ctx):
    spans = trace.of("span", TO_TORCH)
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / len(spans) / 1e6

"""Megabytes of host arrays that ``to_torch`` converts per host batch: the
program's counters ``to_torch.host_bytes`` over ``to_torch.host_batches``
(``data/graph.py``), over every call of the run so far (set-up's warm-up
and the traced requests: the same pool)."""

from portbench import program


def read(trace, ctx):
    nbytes = program.counter(ctx, "to_torch.host_bytes")
    batches = program.counter(ctx, "to_torch.host_batches")
    if not nbytes or not batches:
        return None
    return nbytes / batches / 1e6

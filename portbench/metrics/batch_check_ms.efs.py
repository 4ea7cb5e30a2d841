"""Milliseconds of ``to_torch``'s host checks per E/F/S request: the
program's span ``m3gnet.to_torch.check`` (``data/graph.py``: the sortedness
and range checks of a host batch's indices, numpy on the host), summed
inside each traced request and averaged over the requests."""

from portbench import program


def read(trace, ctx):
    return program.host_ms(trace, ctx, "m3gnet.to_torch.check")

"""Milliseconds of ``to_torch``'s copies per E/F/S request: the program's
span ``m3gnet.to_torch.copy`` (``data/graph.py``: every field of the batch
made a device tensor; from pageable host memory a copy blocks the host),
summed inside each traced request (the host batch's call and the
potential's call on the tensor batch) and averaged over the requests."""

from portbench import program


def read(trace, ctx):
    return program.host_ms(trace, ctx, "m3gnet.to_torch.copy")

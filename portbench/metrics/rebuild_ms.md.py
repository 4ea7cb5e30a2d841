"""Milliseconds of the host's rebuild per MD chunk: the program's span
``m3gnet.md.rebuild`` (``simulate/md.py`` ``run_md``: the skin list's
neighbour search and triplets, the padded batch, ``to_torch`` and the
velocities and masses on the device), averaged over the traced chunks."""

from portbench import program


def read(trace, ctx):
    return program.host_ms(trace, ctx, "m3gnet.md.rebuild")

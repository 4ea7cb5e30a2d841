"""Device milliseconds of CHGNet's bond graph in the forward, per E/F/S
request: the device records of the kernels launched inside the program's
spans ``chgnet.bond_graph`` (``models/chgnet.py``: the angles' geometry,
Fourier basis and bond-pair weights, then each bond conv with its angle
update), over the requests whose every such launch has its record. The
force backward through the bond graph runs outside these spans and is not
counted."""

from portbench import program


def read(trace, ctx):
    return program.device_ms(trace, ctx, "chgnet.bond_graph")

"""Device milliseconds of the three-body stage's forward per E/F/S request:
the device records of the kernels launched inside the program's spans
``m3gnet.threebody`` (``models/m3gnet.py``: the stage's set-up, the per-edge
factors or the T-scale basis, and each block's aggregation), over the
requests whose every such launch has its record. The force backward
through the stage runs outside these spans and is not counted."""

from portbench import program


def read(trace, ctx):
    return program.device_ms(trace, ctx, "m3gnet.threebody")

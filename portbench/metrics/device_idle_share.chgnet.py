"""The device's idle share (%) of a traced CHGNet window: 1 - the union
of its recorded busy intervals (kernels, copies, fills) over the window
from the first traced request's start to the last one's end."""

from portbench import roofline


def read(trace, ctx):
    return roofline.idle_share(trace)

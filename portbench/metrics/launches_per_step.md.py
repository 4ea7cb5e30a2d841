"""Kernel launches per MD step: the host's runtime launch records inside
the traced chunks (the rebuild's copy and index included) over their
steps."""

from portbench import roofline


def read(trace, ctx):
    return roofline.launches_per_step(trace)

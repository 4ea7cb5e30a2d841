"""Kernel launches per E/F/S request: the host's runtime launch records
inside each traced request (every kernel: the port's hand kernels and
torch's), averaged over the requests."""

from portbench import roofline


def read(trace, ctx):
    return roofline.launches_per_step(trace)

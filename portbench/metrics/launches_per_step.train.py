"""Kernel launches per train step: the host's runtime launch records inside
each traced step (loss, double backward, Adam; every kernel), averaged."""

from portbench import roofline


def read(trace, ctx):
    return roofline.launches_per_step(trace)

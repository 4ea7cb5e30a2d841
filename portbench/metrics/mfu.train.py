"""The whole train step's share (%) of the card's float32 peak: the
matrix-product FLOPs of the configuration at the batch's real sizes
(``roofline.model_flops``) times 6 passes (the forward; the force backward,
one product a layer; the loss's backward through it, two; and through the
forward, two), over the steps' host-clock time."""

from portbench import roofline

PASSES = 6


def read(trace, ctx):
    return roofline.mfu(trace, ctx, PASSES)

"""The whole MD step's share (%) of the card's float32 peak: one force
evaluation a step, the matrix-product FLOPs of the configuration at the
chunk's real sizes (``roofline.model_flops``) times 2 (forward and the
force backward), over the chunks' host-clock time, rebuilds included."""

from portbench import roofline

PASSES = 2


def read(trace, ctx):
    return roofline.mfu(trace, ctx, PASSES)

"""The whole E/F/S request's share (%) of the card's float32 peak: the
matrix-product FLOPs of the configuration at each traced batch's real sizes
(``roofline.model_flops``: every dense layer and the three-body stage's
contraction, forward) times 2 (the force backward takes about one forward's
products), over the requests' host-clock time."""

from portbench import roofline

PASSES = 2


def read(trace, ctx):
    return roofline.mfu(trace, ctx, PASSES)

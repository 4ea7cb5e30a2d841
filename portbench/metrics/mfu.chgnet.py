"""The whole CHGNet E/F/S request's share (%) of the card's float32 peak:
the matrix-product FLOPs of the configuration (``kinds/chgnet_screen.py``
``model_flops``: the bases' linear maps, every gated MLP and linear layer,
the readout; forward) at the traced batches' real atoms and at the angles
and bonds that the program counted over the traced requests (its counters
``chgnet.angles`` and ``chgnet.bonds``, ``ctx.counted``), times 2 (the
force backward takes about one forward's products: the inputs' gradients,
not the weights'), over the requests' host-clock time."""

from portbench import roofline
from portbench.kinds import chgnet_screen

PASSES = 2


def read(trace, ctx):
    spans = trace.spans()
    counted = getattr(ctx, "counted", None)
    if not spans or not roofline.on_device(trace) or not counted or not counted["chgnet.angles"]:
        return None
    work = {"atoms": sum(w["atoms"] * w["steps"] for w in trace.work),
            "bonds": counted["chgnet.bonds"], "angles": counted["chgnet.angles"]}
    flops = chgnet_screen.model_flops(ctx.config, work) * PASSES
    seconds = sum(s.end - s.start for s in spans) / 1e9
    return 100.0 * flops / seconds / roofline.peaks(ctx)[ctx.config["peak"] + "_flops_per_s"]

"""Host milliseconds of the weights' gradient per train step: the program's
span ``m3gnet.train.grad`` (``train/loop.py`` ``Trainer.gradients``: the
backward of the loss through the force graph, launched by the autograd
engine), averaged over the traced steps."""

from portbench import program


def read(trace, ctx):
    return program.host_ms(trace, ctx, "m3gnet.train.grad")

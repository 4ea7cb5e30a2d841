"""Device milliseconds of the optimiser step per train step: the device
records of the kernels launched inside the program's span
``m3gnet.train.adam`` (``train/loop.py`` ``Trainer.apply_gradients``),
over the steps whose every such launch has its record."""

from portbench import program


def read(trace, ctx):
    return program.device_ms(trace, ctx, "m3gnet.train.adam")

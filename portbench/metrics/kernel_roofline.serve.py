"""The port's kernel ops (metrics/ops.json) in the traced frames: their
least seconds (work.py) over the device seconds of their ranges and
backward nodes, in %."""

from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "frame")

"""Kernel launches a step in the traced steps (the profiler's kernel
events): the host dispatch of the step."""

from portbench.readers import launches


def read(ctx):
    return launches(ctx, "step")

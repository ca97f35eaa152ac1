"""Kernel launches a frame in the traced frames (the profiler's kernel
events): the host dispatch of the frame."""

from portbench.readers import launches


def read(ctx):
    return launches(ctx, "frame")

"""Milliseconds a frame in which the card ran a kernel, memcpy or memset
(the union of their intervals in the traced frames)."""

from portbench.readers import device_ms


def read(ctx):
    return device_ms(ctx, "frame")

"""The timed window's model FLOP/s (work.FlopCounter's count of one step,
the kernels charged their algorithms' operations, times the window's
steps over its seconds) over the card's dense bf16 peak, in %."""

from portbench.readers import mfu


def read(ctx):
    return mfu(ctx, "step")

"""The share of the traced window in which the card ran nothing, in %."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "frame")

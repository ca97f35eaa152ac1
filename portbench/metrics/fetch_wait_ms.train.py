"""Milliseconds a step that `train_epoch` blocked in its metric fetch,
waiting for the card (its counter wait_s over the timed window, by its
own count of steps): the host ahead of the card reads high, a host that
paces the card near 0."""

from portbench.readers import counter_ms


def read(ctx):
    return counter_ms(ctx, "step", "wait_s")

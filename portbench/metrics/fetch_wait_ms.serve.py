"""Milliseconds a frame that the frame predictor's `fetch` blocked on
its first copy back, waiting for the card (`run.stats` wait_s over the
timed window, by its own count of frames)."""

from portbench.readers import counter_ms


def read(ctx):
    return counter_ms(ctx, "frame", "wait_s")

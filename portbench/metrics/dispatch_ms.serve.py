"""Milliseconds a request spent in the frame predictor's `dispatch`
(staging copy and enqueue), by the benchmark's own span around it, over
every request of the timed window."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "dispatch_s")

"""Host-blocking CUDA calls (stages.SYNC_CALLS) made inside the
program's `livecell.step` span, a traced step: the steps' waits for the
card (the epoch's one metric fetch lies outside the step)."""

from portbench.readers import syncs


def read(ctx):
    return syncs(ctx, "step")

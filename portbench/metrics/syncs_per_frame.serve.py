"""Host-blocking CUDA calls (stages.SYNC_CALLS) made inside the
program's `livecell.frame` span, a traced frame."""

from portbench.readers import syncs


def read(ctx):
    return syncs(ctx, "frame")

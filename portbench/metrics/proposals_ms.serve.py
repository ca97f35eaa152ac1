"""Device milliseconds a traced frame in the program's span
`livecell.proposals` (proposal decoding and NMS; stages.read)."""

from portbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "frame", "proposals")

"""Device milliseconds a traced frame in the program's span
`livecell.features` (the trunk and the feature pyramid; stages.read)."""

from portbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "frame", "features")

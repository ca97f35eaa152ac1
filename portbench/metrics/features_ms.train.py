"""Device milliseconds a traced step in the program's span
`livecell.features` (the trunk and the feature pyramid), the backward
nodes of its forward ops charged to it (stages.read)."""

from portbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "step", "features")

"""Device milliseconds a traced step in the program's span
`livecell.update` (the gradient norm, the clip and the optimizer's
update), the backward nodes of its forward ops charged to it
(stages.read)."""

from portbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "step", "update")

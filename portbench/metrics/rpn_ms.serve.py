"""Device milliseconds a traced frame in the program's span `livecell.rpn`
(the RPN head; stages.read)."""

from portbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "frame", "rpn")

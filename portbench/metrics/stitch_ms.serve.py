"""Device milliseconds a traced frame in the program's span
`livecell.stitch` (the frame predictor's stitch of the tiles'
detections; stages.read)."""

from portbench.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "frame", "stitch")

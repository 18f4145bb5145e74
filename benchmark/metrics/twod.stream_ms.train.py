"""Stream milliseconds a step of the 2D block (the span `train.twod`, the whole of
`Trainer._2d_losses`: normals, raycasts, depth chain, 2D losses and their torch ops): device work
plus the idle time between its markers, over the counter `train.steps`."""

from lib import program


def read(ctx):
    return program.per_count(ctx, ("train.twod",), "train.steps", "stream")

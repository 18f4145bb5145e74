"""Stream milliseconds a step of the discriminator (the span `train.disc`: its three calls, its
losses, its backward, the read of the gate and its Adam step): device work plus the idle time
between its markers, over the counter `train.steps`."""

from lib import program


def read(ctx):
    return program.per_count(ctx, ("train.disc",), "train.steps", "stream")

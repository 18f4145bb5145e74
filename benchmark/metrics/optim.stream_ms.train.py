"""Stream milliseconds a step of the two Adam steps (the spans `train.optim` and
`train.disc_optim`), over the counter `train.steps`."""

from lib import program


def read(ctx):
    return program.per_count(ctx, ("train.optim", "train.disc_optim"), "train.steps", "stream")

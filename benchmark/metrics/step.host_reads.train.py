"""Reads back to the host a step (the counter `train.host_reads` of `Trainer.step`, one at
each span `train.host_read`: the discriminator's gate, the synchronising inverse of the view
matrices in the 2D block, and the depth gate with `skip_batch_on_bad_depth`), over the counter
`train.steps`."""

from lib import program


def read(ctx):
    return program.count_per(ctx, "train.host_reads", "train.steps")

"""Host milliseconds a step inside the calls that wait for the device (the spans
`train.host_read` of `Trainer.step`: the synchronising inverse of the view matrices in the 2D
block, the discriminator's gate, and the depth gate with `skip_batch_on_bad_depth`), over the
counter `train.steps`."""

from lib import program


def read(ctx):
    return program.per_count(ctx, ("train.host_read",), "train.steps", "host")

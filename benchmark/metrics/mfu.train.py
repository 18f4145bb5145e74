"""The window's model operations (generator forward and backward, the discriminator's three calls a
step) over the window's seconds times the float32 peak, in percent."""

from lib import readers


def read(ctx):
    return readers.mfu(ctx)

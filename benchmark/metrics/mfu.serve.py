"""The window's model operations (the generator's forward over the real windows) over the window's
seconds times the float32 peak, in percent."""

from lib import readers


def read(ctx):
    return readers.mfu(ctx)

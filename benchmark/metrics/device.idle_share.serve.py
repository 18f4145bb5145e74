"""1 - (union of the device's operation intervals / the window), in percent."""

from lib import readers


def read(ctx):
    return readers.idle_share(ctx)

"""Least time of the 7 other convs' forward over the device time of the library-conv kernels, in
percent."""

from lib import readers


def read(ctx):
    return readers.roofline(ctx, ("libconv",), "library convs")

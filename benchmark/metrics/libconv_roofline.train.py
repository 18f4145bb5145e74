"""Least time of the library's convs over the device time of the library-conv kernels, in percent:
the generator's 7 convs that are not 3^3 (forward, dx but of the entry convs, dW) and the patch
discriminator's 2D convs (its three calls a step), whose kernels are cuDNN's too and cannot be told
apart from the 3D convs' by name."""

from lib import readers


def read(ctx):
    return readers.roofline(ctx, ("libconv", "disc"), "library convs")

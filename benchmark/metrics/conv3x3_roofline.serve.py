"""Least time of the 28 3^3 stride-1 convs' forward over the device time of the hand-conv kernels
(K1, K3), in percent."""

from lib import readers


def read(ctx):
    return readers.roofline(ctx, ("conv3x3",), "hand convs K1-K3")

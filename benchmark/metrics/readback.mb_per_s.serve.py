"""Megabytes a second of the stitched scene read back to the host (the counter
`serve.bytes_down`, the sizes of the arrays that `_Stitcher.finalize` reads), over the stream
seconds of the spans `serve.readback`: from the device reaching the span's start, after the
work queued ahead of it, to its end. The span's host time also holds that wait, which on a
card is most of it."""

from lib import program


def read(ctx):
    return program.per_second(ctx, "serve.bytes_down", ("serve.readback",), "stream", unit=1e6)

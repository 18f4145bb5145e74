"""Megabytes a second that the room's set-up moves to the device (the counter
`serve.bytes_up`, the sizes of the scene's and the targets' arrays as they are uploaded), over
the host seconds of the spans `serve.prep` and `serve.stitcher_init`, which also hold their
conversions and `np.pad`."""

from lib import program


def read(ctx):
    return program.per_second(ctx, "serve.bytes_up", ("serve.prep", "serve.stitcher_init"),
                              "host", unit=1e6)

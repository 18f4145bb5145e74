"""Stream milliseconds a room of the stitcher (the spans `serve.stitch`, one a window batch, and
`serve.normalize`), over the counter `serve.rooms`."""

from lib import program


def read(ctx):
    return program.per_count(ctx, ("serve.stitch", "serve.normalize"), "serve.rooms", "stream")

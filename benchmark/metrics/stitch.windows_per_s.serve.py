"""Windows a second through the stitcher (the counter `serve.windows`, every window of the
room, the padded tail of the last batch left out), over the stream seconds of the spans
`serve.stitch`: a rate of the stitcher's adds that does not scale with the room's size, as
`stitch.stream_ms.serve` does."""

from lib import program


def read(ctx):
    return program.per_second(ctx, "serve.windows", ("serve.stitch",), "stream")

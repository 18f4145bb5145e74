"""Host milliseconds a room from the call's entry until the padded scene and the stitcher's
targets are on the device (the spans `serve.prep` and `serve.stitcher_init`: crops, conversions,
`np.pad`, pageable uploads, `prep_compact_scene`), over the counter `serve.rooms`."""

from lib import program


def read(ctx):
    return program.per_count(ctx, ("serve.prep", "serve.stitcher_init"), "serve.rooms", "host")

"""Host milliseconds of one window batch of `run_chunked_inference`'s loop (the spans
`serve.batch`: slicing the windows out of the scene on the device, the generator's forward and
the stitcher's update, as the host enqueues or waits for them), over the counter
`serve.batches`."""

from lib import program


def read(ctx):
    return program.per_count(ctx, ("serve.batch",), "serve.batches", "host")

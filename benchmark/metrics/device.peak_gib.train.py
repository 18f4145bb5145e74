"""torch.cuda.max_memory_allocated() over the window, GiB."""

from lib import readers


def read(ctx):
    return readers.peak_gib(ctx)

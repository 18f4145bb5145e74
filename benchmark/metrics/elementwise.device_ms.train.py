"""Device milliseconds a step of the kernels classified elementwise."""

from lib import readers


def read(ctx):
    return readers.device_ms_per_item(ctx, "elementwise")

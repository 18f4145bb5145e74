"""Device milliseconds a step of the raycaster (K4-K7, K12) and the depth chain (K9-K11)."""

from lib import readers


def read(ctx):
    return readers.device_ms_per_item(ctx, "2D block")

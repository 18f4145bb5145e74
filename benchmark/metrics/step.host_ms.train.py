"""Host milliseconds inside Trainer.step a call, until it returns (the benchmark's span around the
call)."""

from lib import readers


def read(ctx):
    return readers.host_ms(ctx, "Trainer.step")

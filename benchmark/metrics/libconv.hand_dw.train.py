"""Library convs whose weight gradient the hand kernel computes, a step (the counter
`train.libconv_dw`, one for each of the generator's convs that are not 3^3 which took
`ops/libconv_dw.py::library_conv` in the step's forward), over the counter `train.steps`:
7 where all seven do. The port counts 0 for each library conv of a training forward that
keeps the library's weight gradient, so a step where none takes the hand kernel reads 0.
None where the record has no such counter at all: a port without the hand weight
gradient, which never counts it."""

from lib import program


def read(ctx):
    record = program.record_of(ctx)
    if not record or "train.libconv_dw" not in record["counts"]:
        return None
    return program.count_per(ctx, "train.libconv_dw", "train.steps")

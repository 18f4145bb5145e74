"""Small sizes of the cells for runs of the harness on the CPU."""

TRAIN = {"config": {"train": {"input_dim": [32, 32, 32], "style_width": 48,
                              "style_height": 32}},
         "traffic": {"pool_batches": 4}}
SERVE = {"config": {"serve": {"chunk_dims": [32, 32, 32], "stride": 16, "max_height": 32,
                              "window_batch": 4}},
         "traffic": {"rooms": [[32, 64, 72]], "pool_per_size": 2,
                     "chunk_footprint": [32, 32], "check_rooms": 2}}
SMALL = {"train-full-b2": TRAIN, "train-full-b8": TRAIN, "serve-chunked": SERVE}


def run_small(workload, seed=2147483659, seconds=1.0, trace=0, patch=None, overrides=None):
    import run

    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.execute(args, device="cpu", patch=patch, overrides=overrides or SMALL[workload])

"""The readings that the limits of ``limits/<cell>.json`` are set from, in one
process on the card:

    python3 benchmark/tools/readings.py --workload <cell> --seeds 12 --control-seeds 3 \
        --first-seed <n> [--out FILE]

For each of ``--seeds`` seeds, the program's numbers against the reference
(the cell's own sizes, no measured window: the training cells' first three
steps, the serving cell's sample of rooms), whose largest is the lower
reading. For each of ``--control-seeds`` seeds, the control (the reference in
TF32, put in the program's place) and each planted fault against the
reference, whose smallest is the upper reading. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=1000003)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import run
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic, driver_path = run.cell_files(bench, args.workload)
    driver = run.load_module(driver_path, "driver")
    weights_path = os.path.join(HERE, config["weights"])
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, t0):
        line = json.dumps(dict(cell=cell["name"], kind=kind, seed=seed, numbers=numbers,
                               seconds=time.perf_counter() - t0,
                               card=torch.cuda.get_device_name(0)))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    dev = "cuda"
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    if traffic["driver"] == "train_step":
        weights = driver.load_weights(weights_path)
        for k, seed in enumerate(seeds):
            t0 = time.perf_counter()
            pool = driver.make_pool(config, traffic, seed, dev, count=driver.FIRST_STEPS)
            prog = driver.Program(config, weights, seed, dev)
            snap = driver.program_snapshot(prog, pool)
            del prog
            torch.cuda.empty_cache()
            ref = driver.reference_snapshot(config, weights, pool, dev)
            emit("program", seed, driver.compare(snap, ref), t0)
            if k < args.control_seeds:
                for kind, kw in (("control_tf32", dict(tf32=True)),
                                 ("fault_half_batch", dict(fault="half_batch")),
                                 ("fault_unchanged", dict(fault="unchanged")),
                                 ("fault_disc_unchanged", dict(fault="disc_unchanged"))):
                    t0 = time.perf_counter()
                    other = driver.reference_snapshot(config, weights, pool, dev, **kw)
                    emit(kind, seed, driver.compare(other, ref), t0)
            torch.cuda.empty_cache()
    else:
        state_dict = driver.load_generator_state(weights_path)
        prog = driver.Program(config, state_dict, dev)
        for k, seed in enumerate(seeds):
            t0 = time.perf_counter()
            ids = driver.check_rooms(traffic, seed)
            rooms = {i: driver.make_room(traffic, seed, i, dev) for i in ids}
            progs = {i: prog.serve(rooms[i]) for i in ids}
            refs = {i: driver.reference_outputs(config, state_dict, rooms[i], dev) for i in ids}
            emit("program", seed, driver.compare([(progs[i], refs[i]) for i in ids]), t0)
            if k < args.control_seeds:
                for kind, kw in (("control_tf32", dict(tf32=True)),
                                 ("fault_half_batch", dict(fault="half_batch")),
                                 ("fault_window_altered", dict(fault="window_altered"))):
                    t0 = time.perf_counter()
                    other = {i: driver.reference_outputs(config, state_dict, rooms[i], dev, **kw)
                             for i in ids}
                    emit(kind, seed, driver.compare([(other[i], refs[i]) for i in ids]), t0)
            torch.cuda.empty_cache()
    if out:
        out.close()


if __name__ == "__main__":
    main()

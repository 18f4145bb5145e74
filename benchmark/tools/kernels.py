"""Every device operation of a cell's window by layer, for holding the layer
files (``layers/*.json``) to what the card runs:

    python3 benchmark/tools/kernels.py --workload <cell> --seed <n> --seconds <s> --out FILE

Builds the cell as a run does, traces a short window and writes one JSON
object: the card, and for each distinct operation name its layer, launches
and device seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1000003)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import run
    import torch
    from lib import layers
    from lib.trace import Tracer

    run.cache_dirs()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, traffic, driver_path = run.cell_files(bench, args.workload)
    driver = run.load_module(driver_path, "driver")
    state = driver.setup(dict(config=config, traffic=traffic, seed=args.seed, device="cuda",
                              weights_path=os.path.join(HERE, config["weights"])))
    tracer = Tracer("cuda")
    tracer.start()
    rec = driver.window(state, args.seconds)
    torch.cuda.synchronize()
    tracer.stop()
    classify = layers.classifier(HERE)
    ops = {}
    for name, a, b in tracer.device_ops():
        o = ops.setdefault(name, dict(layer=classify(name), launches=0, seconds=0.0))
        o["launches"] += 1
        o["seconds"] += (b - a) * 1e-9
    with open(args.out, "w") as f:
        json.dump(dict(workload=args.workload, card=torch.cuda.get_device_name(0),
                       items=rec["items"], ops=ops), f, indent=1, sort_keys=True)
    print(f"{len(ops)} operation names, {rec['items']} items -> {args.out}")


if __name__ == "__main__":
    main()

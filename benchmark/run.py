"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port ``spsg_tpu_torch``. The cell names its configuration
(``configs/<config>.json``) and its traffic (``traffic/<traffic>.json``),
whose ``driver`` names the module under ``drivers/`` that builds the inputs,
drives the port and compares its outputs with the plain reference
(``reference/``). Per-layer metrics are read by ``metrics/<name>.py`` (or,
where there is none, by the reader of the name with its last dotted part
taken off: ``mfu.train.b8`` by ``mfu.train.py``; an end-to-end metric
``train_chunks_per_s.b8`` is the driver's ``train_chunks_per_s``) from the
traced run (``--trace 1``): the profiler's device trace, reduced by
``lib/trace.py`` with the layers of ``layers/*.json``, and the operations
and bounds of ``work/``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``; its
last key, ``compared``, holds each number compared with its limit, which are
also the last lines of standard error. A run exits non-zero, and prints no
result, without a CUDA device (or fewer than the cell asks for), when JAX,
jaxlib, flax or the JAX package ``spsg_tpu`` is loaded, or when the port is
absent.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str):
    """(cell entry, configuration, traffic, driver path) of a cell, found by
    the names in ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in BENCHMARK.json ({', '.join(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    driver = os.path.join(HERE, "drivers", traffic["driver"] + ".py")
    return cell, config, traffic, driver


def reported(bench: dict, cell: dict, key: str):
    """The metrics of ``bench[key]`` that this cell reports: those that list
    it, and (for per-layer metrics without a list) those whose ``moves`` it
    reports."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    if key == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def bases(name: str):
    """A metric's name, then the names it extends by dotted parts, longest
    first: ``mfu.train.b8``, ``mfu.train``, ``mfu``. A metric is read as the
    first of them that has a reader or a value: a cell's twin of a metric
    (``train_chunks_per_s.b8``) is measured as the metric is."""
    parts = name.split(".")
    return [".".join(parts[:n]) for n in range(len(parts), 0, -1)]


def reader_path(name: str) -> str:
    """The reader of a per-layer metric: ``metrics/<base>.py`` of the first
    of the name's bases that has one."""
    for base in bases(name):
        path = os.path.join(HERE, "metrics", base + ".py")
        if os.path.isfile(path):
            return path
    fail(f"no reader for the per-layer metric {name!r} under metrics/")


def cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout (the port
    builds its own under ``spsg_tpu_torch/ops/_build``)."""
    base = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "nv")


def _merged(d: dict, over: dict) -> dict:
    out = dict(d)
    for k, v in over.items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def execute(args, device: str = "cuda", patch=None, overrides=None) -> dict:
    """One run; returns the result object. ``device`` "cpu", ``patch`` (a
    function given the driver module before set-up) and ``overrides``
    ({"config": ..., "traffic": ...} merged into the cell's files: small
    sizes) are the tests' hooks."""
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    from lib import imports, layers
    from lib import trace as trace_lib

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic, driver_path = cell_files(bench, args.workload)
    overrides = overrides or {}
    config = _merged(config, overrides.get("config", {}))
    traffic = _merged(traffic, overrides.get("traffic", {}))
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            fail(f"the cell needs {cell['chips']} CUDA device(s); "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    if importlib.util.find_spec("spsg_tpu_torch") is None:
        fail("the port spsg_tpu_torch is not in this checkout")
    driver = load_module(driver_path, "driver_" + traffic["driver"])
    if patch is not None:
        patch(driver)
    # float32 is true float32: cuDNN and cuBLAS without TF32, as the port sets it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = dict(config=config, traffic=traffic, seed=args.seed, device=device,
               weights_path=os.path.join(HERE, config["weights"]))
    t_imports = time.perf_counter() - T_START
    state = driver.setup(ctx)
    bad = imports.loaded_forbidden()
    if bad:
        fail("set-up loaded " + ", ".join(bad), 3)
    tracer = None
    if args.trace:
        tracer = trace_lib.Tracer(device)
        tracer.start()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    rec = driver.window(state, float(args.seconds))
    if device == "cuda":
        torch.cuda.synchronize()
    if tracer is not None:
        tracer.stop()
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    bad = imports.loaded_forbidden()
    if bad:
        fail("the run loaded " + ", ".join(bad), 3)

    t_window = time.perf_counter()
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in state.get("phases", {}).items())
    print(f"benchmark: set-up {setup_s:.3f} s (imports and start {t_imports:.3f} s, {phases}), "
          f"window {rec['window_s']:.3f} s, {rec['items']} items", file=sys.stderr)
    if args.trace:
        peaks = load_json(os.path.join(HERE, "peaks.json"))
        dev_ops = tracer.device_ops()
        window = trace_lib.window_of(rec["spans"])
        summary = (trace_lib.reduce(dev_ops, rec["spans"], layers.classifier(HERE), window)
                   if window is not None else None)
        if summary is not None and dev_ops:
            first = (min(a for _, a, _ in dev_ops) - window[0]) * 1e-6
            last = (window[1] - max(b for _, _, b in dev_ops)) * 1e-6
            print(f"benchmark: the device's first operation {first:.3f} ms after the window's "
                  f"start, its last {last:.3f} ms before its end", file=sys.stderr)
        tracer = None
        rctx = dict(trace=summary, work=driver.window_work(state, rec, peaks), peaks=peaks,
                    items=rec["items"], host=trace_lib.Spans.seconds_of(rec["spans"]),
                    memory_peak_bytes=memory_peak)
        metrics = {}
        for m in reported(bench, cell, "per_layer"):
            reader = load_module(reader_path(m["name"]), "metric_" + m["name"].replace(".", "_"))
            v = reader.read(rctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(state, rec)
        e2e["setup_s"] = setup_s
        metrics = {}
        for m in reported(bench, cell, "end_to_end"):
            value = next((e2e[b] for b in bases(m["name"]) if b in e2e), None)
            if value is None:
                fail(f"the driver gives no value for {m['name']!r}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    t_check = time.perf_counter()
    if args.trace:
        print(f"benchmark: trace read in {t_check - t_window:.3f} s "
              f"({len(dev_ops)} device operations)", file=sys.stderr)
    driver.release(state)
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check(state, rec)
    print(f"benchmark: reference and comparison {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    limits = load_json(os.path.join(HERE, "limits", cell["name"] + ".json"))
    compared = {}
    for k, v in numbers.items():
        if k not in limits:
            fail(f"no limit for the compared number {k!r} in limits/{cell['name']}.json")
        compared[k] = {"value": v, "limit": limits[k]}
    correct = rec["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": rec["items"], "failed": rec["failed"],
              "metrics": metrics}
    if device == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if args.trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["compared"] = compared
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    cache_dirs()
    result = execute(args)
    for k, c in result["compared"].items():
        print(f"compared {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()


if __name__ == "__main__":
    main()

"""The run's result line: its keys, its metrics as BENCHMARK.json names
them, ``compared`` last; and the refusals (no card, no port)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from _small import run_small
from conftest import BENCH, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload,trace", [("train-full-b2", 0), ("serve-chunked", 0),
                                            ("train-full-b2", 1), ("train-full-b8", 0),
                                            ("train-full-b8", 1)])
def test_result_line(workload, trace):
    r = run_small(workload, trace=trace)
    assert list(r)[:5] == KEYS and list(r)[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    bench = _bench()
    e2e = {m["name"]: m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        per = {m["name"]: m for m in bench["per_layer"] if workload in m["workloads"]}
        assert set(r["metrics"]) <= set(per)
    else:
        assert set(r["metrics"]) == set(e2e)
        for k, m in r["metrics"].items():
            assert m["unit"] == e2e[k]["unit"] and m["value"] > 0
    for k, c in r["compared"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def _run_main(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train-full-b2",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_refuses_without_a_card():
    p = _run_main(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".bench_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = _run_main(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""

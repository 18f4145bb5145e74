"""The harness finds everything by name: each cell's configuration, traffic,
driver and limits, each per-layer metric's reader, each layer's name file;
and a cell, metric and layer added as new files in a copy of the benchmark
(no file edited) are found and run."""

import glob
import json
import os
import re
import shutil
import sys

import pytest
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves():
    import run

    b = _bench()
    for w in b["workloads"]:
        cell, config, traffic, driver = run.cell_files(b, w["name"])
        assert os.path.isfile(driver)
        assert os.path.isfile(os.path.join(BENCH, config["weights"]))
        assert os.path.isfile(os.path.join(BENCH, "limits", w["name"] + ".json"))
        assert run.reported(b, cell, "end_to_end") and run.reported(b, cell, "per_layer")
        assert "setup_s" in {m["name"] for m in run.reported(b, cell, "end_to_end")}


def test_every_metric_has_a_reader_and_every_layer_file_is_whole():
    import run

    b = _bench()
    for m in b["per_layer"]:
        path = run.reader_path(m["name"])
        assert os.path.isfile(path), path
        assert "def read(ctx)" in open(path).read()
    # a name that extends another's by a dotted part is read by the other's reader
    assert run.reader_path("mfu.train.b8") == os.path.join(BENCH, "metrics", "mfu.train.py")
    for path in glob.glob(os.path.join(BENCH, "layers", "*.json")):
        d = json.load(open(path))
        assert set(d) == {"layer", "priority", "patterns"}


def test_the_file_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len(json.dumps(b)) <= 64 * 1024


def test_a_cell_metric_and_layer_added_as_files_are_found(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = _bench()
    b["workloads"].append({"name": "train-full-b4", "config": "spsg-nf20-train",
                           "traffic": "train-b4", "chips": 1, "why": "an added cell"})
    for m in b["end_to_end"]:
        if m["name"] == "train_chunks_per_s":
            m["workloads"].append("train-full-b4")
    b["per_layer"].append({"name": "copies.device_ms.train", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "copies",
                           "moves": "train_chunks_per_s", "workloads": ["train-full-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    tb = tmp_path / "benchmark"
    (tb / "traffic" / "train-b4.json").write_text(json.dumps(
        {"driver": "train_step", "batch": 4, "pool_batches": 4}))
    shutil.copy(tb / "limits" / "train-full-b2.json", tb / "limits" / "train-full-b4.json")
    (tb / "metrics" / "copies.device_ms.train.py").write_text(
        "from lib import readers\n\n\ndef read(ctx):\n"
        "    return readers.device_ms_per_item(ctx, 'copies')\n")
    (tb / "layers" / "new_kernel.json").write_text(json.dumps(
        {"layer": "library convs", "priority": 5, "patterns": ["my_new_conv_kernel"]}))
    ours = ("run", "lib", "work", "gen", "reference")

    def purge():
        return {k: sys.modules.pop(k) for k in list(sys.modules) if k.split(".")[0] in ours}

    saved = purge()
    sys.path.insert(0, str(tb))
    try:
        import run
        from lib import layers

        assert run.HERE == str(tb)
        cell, config, traffic, driver = run.cell_files(b, "train-full-b4")
        assert traffic["batch"] == 4 and driver.startswith(str(tb))
        assert [m["name"] for m in run.reported(b, cell, "per_layer")] == ["copies.device_ms.train"]
        assert layers.classifier(str(tb))("void my_new_conv_kernel<float>") == "library convs"
        args = run.parse(["--workload", "train-full-b4", "--seed", "5", "--seconds", "0.5",
                          "--trace", "0"])
        r = run.execute(args, device="cpu", overrides={
            "config": {"train": {"input_dim": [32, 32, 32], "style_width": 48,
                                 "style_height": 32}}})
        assert r["attempted"] >= 1 and set(r["metrics"]) == {"train_chunks_per_s", "setup_s"}
    finally:
        sys.path.remove(str(tb))
        purge()
        sys.modules.update(saved)


@pytest.mark.parametrize("cell", ["train-full-b2", "serve-chunked"])
def test_the_layer_files_take_every_traced_kernel_to_its_layer(cell):
    """Every device operation of a traced window on the card (``tools/kernels.py``)
    falls in the layer it belongs to: cuDNN's conv kernels (the generator's
    and the discriminator's) in library convs, cuBLAS's matmuls (spectral
    norm, colour space) and PyTorch's own kernels in elementwise, K1-K3 and
    K4-K12 in theirs."""
    from lib import layers

    with open(os.path.join(BENCH, "tests", "data", f"kernels_{cell}.json")) as f:
        want = json.load(f)["layers"]
    classify = layers.classifier(BENCH)
    got = {n: classify(n) for n in want}
    assert got == want
    assert "unclassified" not in got.values()

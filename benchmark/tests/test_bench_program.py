"""The program's own spans in the traced run: a traced run on the CPU reports
the metrics read from the program's record, which the port's recorder keeps
over the profiled window (the stream ones have nothing to read there),
``ctx["host"]`` keeps the benchmark's spans alone, and a port without a
recorder gives no record and no error."""

import json
import os

import pytest
from _small import run_small
from conftest import ROOT

NEW = {"train-full-b2": ["step.read_wait_ms.train", "twod.stream_ms.train",
                         "disc.stream_ms.train", "optim.stream_ms.train",
                         "step.host_reads.train"],
       "serve-chunked": ["stitch.stream_ms.serve", "prep.host_ms.serve", "prep.mb_per_s.serve",
                         "readback.mb_per_s.serve", "batch.host_ms.serve",
                         "stitch.windows_per_s.serve"]}
NEW["train-full-b8"] = [n + ".b8" for n in NEW["train-full-b2"]]
HOST_CLOCK = {"step.read_wait_ms.train", "step.read_wait_ms.train.b8", "step.host_reads.train",
              "step.host_reads.train.b8", "prep.host_ms.serve", "prep.mb_per_s.serve",
              "batch.host_ms.serve"}
BENCH_SPANS = {"train-full-b2": {"window", "upload", "Trainer.step", "metrics read"},
               "serve-chunked": {"window", "run_chunked_inference", "between scenes"}}
BENCH_SPANS["train-full-b8"] = BENCH_SPANS["train-full-b2"]

def _spy(seen):
    """A patch of ``run.load_module`` that keeps the context the readers get."""
    import run

    load = run.load_module

    def spy(path, name):
        mod = load(path, name)
        if name.startswith("metric_"):
            read = mod.read

            def keep(ctx):
                seen["ctx"] = ctx
                return read(ctx)

            mod.read = keep
        return mod

    return spy


@pytest.mark.parametrize("cell", ["train-full-b2", "train-full-b8", "serve-chunked"])
def test_a_traced_run_reads_the_program_record(cell, monkeypatch):
    import run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    listed = [m["name"] for m in run.reported(bench, cells[cell], "per_layer")]
    assert set(NEW[cell]) <= set(listed)
    seen = {}
    monkeypatch.setattr(run, "load_module", _spy(seen))
    r = run_small(cell, trace=1)
    assert r["correct"] is True
    # on the CPU the spans have no stream markers: those metrics read None
    assert {n for n in NEW[cell] if n in r["metrics"]} == HOST_CLOCK & set(NEW[cell])
    ctx = seen["ctx"]
    assert set(ctx["host"]) == BENCH_SPANS[cell]
    per = "Trainer.step" if cell.startswith("train") else "run_chunked_inference"
    assert len(ctx["host"][per]) == r["attempted"]
    counts = ctx["program"]["counts"]
    assert counts["train.steps" if cell.startswith("train") else "serve.rooms"] == r["attempted"]
    names = {s["name"] for s in ctx["program"]["spans"]}
    assert all(n.startswith(("train.", "serve.")) for n in names)
    assert names.isdisjoint(BENCH_SPANS[cell])


def test_a_port_without_a_recorder_gives_no_record(monkeypatch):
    from lib import program

    import run

    seen = {}
    from spsg_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "drain")  # the port as it was before the recorder
    assert program.record_of({}) is None
    monkeypatch.setattr(run, "load_module", _spy(seen))
    r = run_small("train-full-b2", trace=1)
    assert r["correct"] is True and seen["ctx"]["program"] is None
    assert not set(NEW["train-full-b2"]) & set(r["metrics"])
    assert "mfu.train" in r["metrics"]

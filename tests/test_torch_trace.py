"""The port's span and counter recorder (spsg_tpu_torch/utils/timing.py) on the
CPU: off it records nothing and hands out one shared no-op; on, a full train
step (the tiny config of tests/test_torch_train_step_2d.py) and a chunked
scene call (tests/test_torch_chunked.py's scene) record their span trees,
request ids and counters, and compute the same numbers to the bit as with it
off; PhaseTimer's phases are spans too; the train CLI's --profile_dir writes
the recorder's spans beside the profiler's trace, on its clock."""

import json
import os

import numpy as np
import pytest
import torch

from spsg_tpu_torch.cli import train as cli
from spsg_tpu_torch.data import pipeline, synthetic
from spsg_tpu_torch.inference import chunked
from spsg_tpu_torch.ops import depth as depth_ops
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training.state import init_generator
from spsg_tpu_torch.training.step import Trainer
from spsg_tpu_torch.utils import timing

DIMS = (16, 16, 16)
# tests/test_torch_train_step_2d.py's TINY and FULL
TINY = dict(input_dim=DIMS, nf_gen=4, nf_disc=4, batch_size=2, style_width=48, style_height=32,
            patch_size=16, num_iters_geo_only=2, max_depth_fill_iters=8, min_num_valid_2d=10)
FULL = StepFlags(pred_sdf=True, pred_color=True, pred_semantic=True, use_2d=True, use_disc=True)
STEP_TREE = [("train.step", None), ("train.forward", "train.step"),
             ("train.generator", "train.forward"), ("train.losses3d", "train.forward"),
             ("train.twod", "train.forward"), ("train.host_read", "train.twod"),
             ("train.disc", "train.step"),
             ("train.host_read", "train.disc"), ("train.disc_optim", "train.disc"),
             ("train.backward", "train.step")]
# tests/test_torch_chunked.py's scene and windows: 5 x 6 windows, 5 batches of 7
SCENE, KW = (16, 40, 48), dict(chunk_dims=DIMS, stride=8, pad=2, max_height=16, window_batch=7)


@pytest.fixture
def recorder():
    """The recorder, left off and empty after the test."""
    try:
        yield timing
    finally:
        timing.disable()
        timing.drain()


@pytest.fixture(scope="module")
def batch():
    b = synthetic.make_chunk_batch(2, DIMS, image_dims=(48, 32), seed=1, with_frames=True,
                                   device="cpu")
    b.pop("name")
    b["weight_occ"] = np.float32(1.0)
    return b


def _tree(spans):
    return [(s["name"], None if s["parent"] is None else spans[s["parent"]]["name"])
            for s in spans]


def _nested(spans):
    """Every span inside its parent, with the parent's request id."""
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["stream_ms"] is None
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
            assert s["request"] == p["request"]
    return True


def test_off_records_nothing_and_shares_one_no_op(recorder, batch):
    assert not recorder.RECORDER.on
    a, b = recorder.span("train.x"), recorder.span("serve.y", stream=True)
    assert a is b
    with a:
        recorder.count("train.steps")
    Trainer(TrainConfig(**TINY), device="cpu").step(batch, FULL)
    assert recorder.drain() == {"spans": [], "counts": {}}


@pytest.mark.parametrize("skip_on_depth", [False, True])
def test_a_step_records_its_span_tree_once(recorder, batch, skip_on_depth):
    """With the views computed before the step, the step's reads are the
    inverse of the view matrices, the gate's, and the depth gate's with
    skip_batch_on_bad_depth."""
    trainer = Trainer(TrainConfig(**TINY, skip_batch_on_bad_depth=skip_on_depth), device="cpu")
    precomp = trainer.precompute_views(batch)
    recorder.enable(stream_markers=True)  # no CUDA here: no markers
    trainer.step(batch, FULL, precomp=precomp)
    trainer.step(batch, FULL, precomp=precomp)
    recorder.disable()
    rec = recorder.drain()
    want = STEP_TREE + ([("train.host_read", "train.backward")] if skip_on_depth else []) + [
        ("train.optim", "train.step")]
    assert _tree(rec["spans"]) == want * 2 and _nested(rec["spans"])
    assert [s["request"] for s in rec["spans"]] == [0] * len(want) + [1] * len(want)
    # and the seven library convs whose weight gradient is the hand kernel's, a step
    assert rec["counts"] == {"train.steps": 2, "train.host_reads": 2 * (2 + skip_on_depth),
                             "train.libconv_dw": 2 * 7}


def test_the_plain_depth_fill_counts_its_reads(recorder, batch):
    """In its own counter, ``depth.host_syncs``: ``train.host_reads`` counts
    the step's spans ``train.host_read`` alone."""
    trainer = Trainer(TrainConfig(**TINY), device="cpu")
    depth_ops.reset_host_syncs()
    recorder.enable()
    trainer.step(batch, FULL)
    recorder.disable()
    assert depth_ops.host_syncs["fill_depth_holes"] >= 2
    rec = recorder.drain()
    reads = [s for s in rec["spans"] if s["name"] == "train.host_read"]
    assert rec["counts"]["train.host_reads"] == len(reads) == 2


def test_a_traced_step_computes_what_an_untraced_one_does(recorder, batch):
    a, b = (Trainer(TrainConfig(**TINY), device="cpu", seed=3) for _ in range(2))
    ma = a.step(batch, FULL)
    recorder.enable()
    mb = b.step(batch, FULL)
    recorder.disable()
    assert recorder.drain()["counts"]["train.steps"] == 1
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    for net in ("generator", "discriminator"):
        pa, pb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        assert all(torch.equal(v, pb[k]) for k, v in pa.items())


def _scene():
    s = synthetic.make_scene(dims=SCENE, seed=4)
    return s, pipeline.assemble_sample(
        s.sdf_input, s.sdf_complete, s.input_colors, s.colors, s.semantics, s.known,
        s.world2grid, 3.0, "lab", None)


def _serve(compact):
    scene, sample = _scene()
    gen = init_generator(TrainConfig(input_dim=DIMS, nf_gen=4, weight_disc_loss=0.0),
                         torch.Generator().manual_seed(0), device="cpu")
    feed = (dict(compact_scene=dict(sdf=scene.sdf_input, colors=scene.input_colors))
            if compact else dict(scene_input=sample["input"], scene_mask=sample["mask"]))
    feed.setdefault("scene_input", None)
    feed.setdefault("scene_mask", None)
    out = chunked.run_chunked_inference(
        gen, target_sdf=sample["target_sdf"], known=sample["known"],
        target_semantics=sample["semantics"], device="cpu", **feed, **KW)
    return out, chunked.summarize_iou(out.geo_intersection, out.geo_union,
                                      out.class_intersection, out.class_union,
                                      out.class_weight)


@pytest.mark.parametrize("compact", [False, True])
def test_a_chunked_call_records_a_batch_span_a_window_batch(recorder, compact):
    off = _serve(compact)
    recorder.enable()
    on = _serve(compact)
    recorder.disable()
    rec = recorder.drain()
    spans = rec["spans"]
    batch_tree = [("serve.batch", "serve.room"), ("serve.gather", "serve.batch"),
                  ("serve.forward", "serve.batch"), ("serve.stitch", "serve.batch")]
    assert _tree(spans) == ([("serve.room", None), ("serve.prep", "serve.room"),
                             ("serve.stitcher_init", "serve.room")] + batch_tree * 5
                            + [("serve.finalize", "serve.room"),
                               ("serve.normalize", "serve.finalize"),
                               ("serve.readback", "serve.finalize"), ("serve.iou", None)])
    assert _nested(spans)
    # the call and summarize_iou are two requests
    assert [s["request"] for s in spans if s["parent"] is None] == [0, 1]
    Z, Y, X = SCENE
    padded = Z * (Y + 16) * (X + 16)
    scene_up = Z * Y * X * (4 + 3) if compact else padded * (4 + 1) * 4
    fields = [on[0].sdf, on[0].counts.astype(np.int16), on[0].occ, on[0].colors,
              on[0].sem_labels]
    down = sum(a.nbytes for a in fields) + 2 * 4 + 3 * 14 * 4
    assert rec["counts"] == {"serve.rooms": 1, "serve.windows": 5 * 6, "serve.batches": 5,
                             "serve.bytes_up": scene_up + padded * (4 + 1 + 4),
                             "serve.bytes_down": down}
    a, b = off[0], on[0]
    for f in ("sdf", "colors", "sem_labels", "occ", "counts", "class_intersection",
              "class_union", "class_weight"):
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=f == "sdf"), f
    assert (a.geo_intersection, a.geo_union) == (b.geo_intersection, b.geo_union)
    assert json.dumps(off[1]) == json.dumps(on[1])


def test_stream_markers_need_a_card(recorder):
    recorder.enable(stream_markers=True)
    with recorder.span("serve.stitch", stream=True):
        pass
    recorder.disable()
    (s,) = recorder.drain()["spans"]
    assert s["stream_ms"] is None and s["request"] == 0


def test_a_profiler_session_records_and_starts_afresh(recorder):
    """Left off, the recorder records inside a torch.profiler session (a
    benchmark's traced window); each session starts its record afresh, and
    outside one it is off again."""
    from torch.profiler import ProfilerActivity, profile

    for n in (2, 1):
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n):
                with recorder.span("serve.room", stream=True):
                    recorder.count("serve.rooms")
        assert recorder.span("serve.room") is recorder.span("serve.x")
    assert not recorder.RECORDER.on
    rec = recorder.drain()
    assert [(s["name"], s["request"], s["stream_ms"]) for s in rec["spans"]] == [
        ("serve.room", 0, None)]
    assert rec["counts"] == {"serve.rooms": 1}


def test_phase_timer_phases_are_spans_and_still_report(recorder):
    timer = timing.PhaseTimer(report_every=2)
    lines = []
    recorder.enable()
    for _ in range(2):
        with timer.phase("step"):
            with recorder.span("train.step"):
                pass
        timer.step(log_fn=lines.append)
    recorder.disable()
    spans = recorder.drain()["spans"]
    assert _tree(spans) == [("train.loop.step", None), ("train.step", "train.loop.step")] * 2
    assert [s["request"] for s in spans] == [0, 0, 1, 1]
    assert len(lines) == 1 and lines[0].startswith("Average timings: step: ")
    assert len(timer.history) == 2


def test_the_cli_profile_dir_writes_the_spans_on_the_trace_clock(tmp_path):
    prof = tmp_path / "prof"
    cli.main(["--device", "cpu", "--synthetic_chunks", "4", "--input_dim", "16", "--nf_gen", "4",
              "--num_iters_geo_only", "1", "--weight_disc_loss", "0", "--weight_depth_loss", "0",
              "--max_epoch", "1", "--no_vis", "--save", str(tmp_path / "run"),
              "--profile_dir", str(prof)])
    assert not timing.RECORDER.on
    rec = json.load(open(prof / "spans.json"))
    steps = [s for s in rec["spans"] if s["name"] == "train.step"]
    # two training steps, the validation pass's steps, each its own request
    assert rec["counts"]["train.steps"] == len(steps) >= 2
    assert len({s["request"] for s in steps}) == len(steps)
    assert {"train.loop.step", "train.forward", "train.backward"} <= {
        s["name"] for s in rec["spans"]}
    trace = json.load(open(prof / "trace.json"))
    base = trace["baseTimeNanoseconds"]
    ops = [base + 1000 * float(e["ts"]) for e in trace["traceEvents"]
           if e.get("name", "").startswith("aten::convolution")]
    inside = [t for t in ops if any(s["start_ns"] <= t <= s["end_ns"] for s in steps)]
    assert ops and inside == ops
    assert os.path.getsize(prof / "trace.json") > 0

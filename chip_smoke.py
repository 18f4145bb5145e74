#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spsg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device, nvcc, and nothing else (no network, no dataset, no
trained weights: everything is made from seeds). It exits with a code other
than 0, and without its last line, if there is no CUDA device or if any phase
fails. Phases, each printing one JSON line:

  device   the card (name and power limit as nvidia-smi gives them), versions
  build    builds the CUDA kernels from spsg_tpu_torch/ops/csrc with nvcc
  compare  (summary; the numbers are in the "kernels" line)
           every hand-written kernel against its plain PyTorch version, at a
           toy shape and at the shapes the main path gives it (batch 1), in
           float32 and bfloat16, with times: kernel, plain version, the one
           library call that computes the same function (F.conv3d in true
           float32; a yardstick, the port never calls it for these layers),
           and the least time the card could take (bound)
  path     the main path through the entry points a user calls: the
           whole-scene CLI at full width (nf_gen 20, windows (128,64,64),
           stride 32, window batch 8, colour and semantics) on one synthetic
           (128,160,192) scene with seeded random weights; checks the launch
           counters (23 fused + 5 bare convs per window batch, 4 batches), the
           outputs, IoU.txt; then one window batch with the kernels against
           the same batch with the kernels' plain versions, and a small scene
           on the GPU against the same scene on the CPU
  kernels  one line {"kernels": [...]}: per kernel its launches on the main
           path and its numbers at the heaviest main-path shape, with every
           shape and both storage types nested under "dtypes"
  last     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Tolerances. float32: |kernel - plain| <= 1e-4 on unit-variance outputs (both
accumulate in float32, in different orders); sums within rtol 1e-4. bfloat16:
both round the same float32 sum to bfloat16, so they differ only where the two
sums straddle a rounding boundary, by one step: <= 2e-2 for |y| < 4, and
2**-7 * |y| beyond; sums within rtol 1e-2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device",
          file=sys.stderr)
    sys.exit(2)

import torch.nn.functional as F  # noqa: E402

from spsg_tpu_torch.cli import test_scene_as_chunks as cli  # noqa: E402
from spsg_tpu_torch.inference import chunked  # noqa: E402
from spsg_tpu_torch.models.generator import use_true_float32  # noqa: E402
from spsg_tpu_torch.ops import _build, conv3x3 as conv_ops  # noqa: E402
from spsg_tpu_torch.training import TrainConfig  # noqa: E402
from spsg_tpu_torch.training import state  # noqa: E402

DEV = torch.device("cuda:0")
T0 = time.time()

# NVIDIA H100 SXM data sheet, dense rates: float32 outside the tensor cores,
# bfloat16 in them, HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

SOURCE = "spsg_tpu_torch/ops/csrc/conv3x3.cu"
KERNELS = {
    "conv3x3": "spsg_tpu/ops/pallas_conv.py:127",
    "conv3x3_act_stats": "spsg_tpu/ops/pallas_conv.py:267",
}
# (B, Z, Y, X, Cin, Cout, on the main path?)
TOY = (2, 4, 8, 8, 5, 6, False)
SHAPES = [
    TOY,
    (1, 128, 64, 64, 20, 20, True),
    (1, 128, 64, 64, 100, 40, True),   # decoder_3a, the heaviest layer
    (1, 128, 64, 64, 10, 1, True),
    (1, 128, 64, 64, 20, 14, True),
    (1, 32, 16, 16, 100, 100, True),
]
HEAVIEST = SHAPES[2]


def emit(phase, **kw):
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 1), **kw}), flush=True)


def cuda_ms(fn, reps):
    fn()  # warm up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# --------------------------------------------------------------------------- device
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


# --------------------------------------------------------------------------- build
def phase_build():
    t = time.time()
    _build.build_all()
    info = _build.BUILD_INFO["conv3x3"]
    emit("build", seconds=round(time.time() - t, 2), cached=info["cached"],
         library=os.path.relpath(info["path"]), nvcc_flags=" ".join(_build.NVCC_FLAGS),
         ptxas=_build.ptxas_summary("conv3x3"))


# --------------------------------------------------------------------------- compare
def bound(shape, dtype):
    B, Z, Y, X, Ci, Co = shape[:6]
    vox = B * Z * Y * X
    flops = 2.0 * 27 * Ci * Co * vox
    nbytes = (vox * (Ci + Co) + 27 * Ci * Co) * torch.empty((), dtype=dtype).element_size()
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def check_y(y, ref, dtype, what):
    err = (y.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-4).all())
    else:
        ok = bool((err <= torch.clamp(ref.float().abs() * 2.0 ** -7, min=2e-2)).all())
    if not ok or not torch.isfinite(y.float()).all():
        raise SystemExit(f"chip_smoke: {what}: kernel and plain version disagree "
                         f"(max abs err {err.max().item():.3e})")
    return err.max().item()


def compare_one(shape, dtype, gen):
    B, Z, Y, X, Ci, Co, on_path = shape
    x = torch.randn(B, Z, Y, X, Ci, generator=gen).to(dtype).to(DEV)
    w = (torch.randn(3, 3, 3, Ci, Co, generator=gen) / (27 * Ci) ** 0.5).to(dtype).to(DEV)
    b = (0.1 * torch.randn(Co, generator=gen)).to(DEV)
    big = B * Z * Y * X * Ci * Co > 1e7
    reps, plain_reps = (10, 2) if big else (50, 5)
    bound_ms, bound_by, flops = bound(shape, dtype)
    tag = f"{tuple(shape[:4])} {Ci}->{Co} {str(dtype).split('.')[1]}"
    xc = x.permute(0, 4, 1, 2, 3)                    # (B,C,Z,Y,X) view, same memory
    wc = w.permute(4, 3, 0, 1, 2).contiguous()       # (O,I,3,3,3)
    out = {}

    # conv3x3
    y = conv_ops.conv3x3(x, w)
    torch.cuda.synchronize()
    ref = conv_ops.conv3x3_plain(x, w)
    rec = dict(shape=list(shape[:4]), cin=Ci, cout=Co, main_path=on_path,
               max_abs_err=check_y(y, ref, dtype, f"conv3x3 {tag}"))
    rec["ms"] = cuda_ms(lambda: conv_ops.conv3x3(x, w), reps)
    rec["plain_ms"] = cuda_ms(lambda: conv_ops.conv3x3_plain(x, w), plain_reps)
    rec["library_ms"] = cuda_ms(lambda: F.conv3d(xc, wc, padding=1), reps)
    rec.update(bound_ms=bound_ms, bound_by=bound_by, tflops=flops / rec["ms"] / 1e9)
    out["conv3x3"] = rec
    del y, ref

    # conv3x3_act_stats
    y, s, ss = conv_ops.conv3x3_act_stats(x, w, b)
    torch.cuda.synchronize()
    ry, rs, rss = conv_ops.conv3x3_act_stats_plain(x, w, b)
    rec = dict(shape=list(shape[:4]), cin=Ci, cout=Co, main_path=on_path,
               max_abs_err=check_y(y, ry, dtype, f"conv3x3_act_stats {tag}"))
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want, name in ((s, rs, "sum"), (ss, rss, "sumsq")):
        rel = ((got - want).abs() / want.abs()).max().item()
        if not rel <= rtol:
            raise SystemExit(f"chip_smoke: conv3x3_act_stats {tag}: {name} off by rel {rel:.3e}")
        rec[f"{name}_max_rel_err"] = rel
    y2, s2, ss2 = conv_ops.conv3x3_act_stats(x, w, b)
    rec["repeats_bitwise"] = bool(torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(ss, ss2))
    if not rec["repeats_bitwise"]:
        raise SystemExit(f"chip_smoke: conv3x3_act_stats {tag}: two runs differ")
    del y, s, ss, ry, rs, rss, y2, s2, ss2

    def library():
        v = F.leaky_relu(F.conv3d(xc, wc, b.to(dtype), padding=1), 0.2)
        vf = v.float()
        return v, vf.sum((0, 2, 3, 4)), (vf * vf).sum((0, 2, 3, 4))

    rec["ms"] = cuda_ms(lambda: conv_ops.conv3x3_act_stats(x, w, b), reps)
    rec["plain_ms"] = cuda_ms(lambda: conv_ops.conv3x3_act_stats_plain(x, w, b), plain_reps)
    rec["library_ms"] = cuda_ms(library, reps)
    rec.update(bound_ms=bound_ms, bound_by=bound_by, tflops=flops / rec["ms"] / 1e9)
    out["conv3x3_act_stats"] = rec
    return out


def phase_compare():
    use_true_float32()
    gen = torch.Generator().manual_seed(0)
    results = {k: {"float32": [], "bfloat16": []} for k in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            for name, rec in compare_one(shape, dtype, gen).items():
                results[name][str(dtype).split(".")[1]].append(rec)
            torch.cuda.empty_cache()
    # the per-shape numbers go into the "kernels" line at the end
    emit("compare", tolerance={"float32": "abs 1e-4, sums rtol 1e-4",
                               "bfloat16": "abs max(2e-2, 2**-7*|y|), sums rtol 1e-2"},
         cases=sum(len(v) for r in results.values() for v in r.values()),
         max_abs_err={name: {dt: max(c["max_abs_err"] for c in recs) for dt, recs in r.items()}
                      for name, r in results.items()})
    return results


# --------------------------------------------------------------------------- path
def randomise_bn_statistics(gen, seed):
    """BatchNorm running statistics away from (0, 1), so no norm is the identity."""
    rng = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in gen.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_((0.1 * torch.randn(buf.shape, generator=rng)).to(buf.device))
            elif name.endswith("running_var"):
                buf.copy_(torch.empty(buf.shape).uniform_(0.5, 1.5, generator=rng).to(buf.device))


def scale_conv_weights(gen, gain):
    """kaiming-uniform(a=sqrt(5)) weights shrink the signal layer by layer
    until every output is ~1e-7 and every logit a rounding away from the 0.5
    threshold; a gain of 2 keeps activations O(1), so that comparisons of
    outputs mean something."""
    with torch.no_grad():
        for p in gen.parameters():
            if p.dim() == 5:
                p.mul_(gain)


def centre_occupancy_head(gen, dims):
    """Random weights leave the occupancy logits of a scene all of one sign as
    often as not, and then nothing (or everything) is stitched. Shift the
    head's bias by the median logit of one synthetic chunk, so that about half
    of the voxels are predicted occupied and every accumulator gets work."""
    from spsg_tpu_torch.data import pipeline, synthetic

    s = synthetic.make_scene(dims=dims, seed=99)
    sample = pipeline.assemble_sample(s.sdf_input, s.sdf_complete, s.input_colors, s.colors,
                                      s.semantics, s.known, s.world2grid, 3.0, "lab", None)
    dev = gen.geo_occ_b.bias.device
    x = torch.from_numpy(sample["input"][None]).to(dev)
    m = torch.from_numpy(sample["mask"][None]).to(dev)
    with torch.no_grad():
        occ_l = gen.eval()(x, m, pred_color=False)[0]
        gen.geo_occ_b.bias -= occ_l.median()
    gen.train()


def profile_window_batch(gen, cb, mb):
    """Device time of one window-batch forward by kind of kernel, from
    torch.profiler; "not measured" if the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gen(cb, mb, pred_color=True, pred_semantic=True)
        torch.cuda.synchronize()
    groups = {"hand_conv3x3": 0.0, "hand_reduce_partials": 0.0, "library_conv": 0.0, "other": 0.0}
    names = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        key = ("hand_conv3x3" if "conv3x3_kernel" in e.key
               else "hand_reduce_partials" if "reduce_partials" in e.key
               else "library_conv" if any(t in e.key.lower() for t in
                                          ("cudnn", "xmma", "convolve", "conv", "gemm", "cutlass"))
               else "other")
        groups[key] += us
        names[e.key] = names.get(e.key, 0.0) + us
    total = sum(groups.values())
    if total <= 0:
        return "not measured"
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return dict(total_ms=total / 1e3, by_kind_ms={k: v / 1e3 for k, v in groups.items()},
                top_kernels_ms=[[k[:80], v / 1e3] for k, v in top])


def phase_path(tmp):
    cfg = TrainConfig()  # reference defaults: nf_gen 20, (128,64,64), colour + semantics
    gen = state.init_generator(cfg, torch.Generator().manual_seed(0), DEV)
    scale_conv_weights(gen, 2.0)
    randomise_bn_statistics(gen, 1)
    centre_occupancy_head(gen, (128, 64, 64))
    ckpt = os.path.join(tmp, "model-seed0.pt")
    state.save_checkpoint(ckpt, gen, 0)
    del gen

    # the CLI keeps the stitched scene to itself: record what it passes on
    seen = {}
    real_run = chunked.run_chunked_inference

    def recording_run(generator, scene_input, scene_mask, *a, **kw):
        torch.cuda.synchronize()
        t = time.time()
        out = real_run(generator, scene_input, scene_mask, *a, **kw)
        torch.cuda.synchronize()
        seen.update(out=out, seconds=time.time() - t, generator=generator,
                    scene_input=scene_input, scene_mask=scene_mask)
        return out

    out_dir = os.path.join(tmp, "output")
    chunked.run_chunked_inference = recording_run
    torch.cuda.reset_peak_memory_stats()
    conv_ops.reset_launch_counts()
    t = time.time()
    try:
        summary = cli.main(["--synthetic_scenes", "1", "--model_path", ckpt, "--output", out_dir,
                            "--num_to_vis", "1"])
    finally:
        chunked.run_chunked_inference = real_run
    cli_seconds = time.time() - t
    launches = dict(conv_ops.launch_counts)

    want = {"conv3x3_act_stats": 23 * 4, "conv3x3": 5 * 4}
    if launches != want:
        raise SystemExit(f"chip_smoke: launches on the main path {launches}, expected {want}")
    out = seen["out"]
    dims = (128, 160, 192)
    got = out.counts > 0
    ok = (
        out.sdf.shape == dims and out.colors.shape == dims + (3,)
        and out.sem_labels.shape == dims and out.occ.shape == dims
        and np.isfinite(out.sdf[got]).all() and np.isneginf(out.sdf[~got]).all()
        and got.any() and out.geo_union > 0 and int(out.sem_labels.max()) < 14
        and np.isfinite(summary["geo_iou"]) and np.isfinite(summary["mean_iou"])
        and os.path.isfile(os.path.join(out_dir, "IoU.txt"))
    )
    if not ok:
        raise SystemExit("chip_smoke: the whole-scene outputs are not what they should be")
    iou_lines = open(os.path.join(out_dir, "IoU.txt")).read().split("\n")
    if len(iou_lines) != 30 or float(iou_lines[0]) != summary["geo_iou"]:
        raise SystemExit("chip_smoke: IoU.txt is not in the reference's format")
    rec = dict(
        scene=list(dims), windows=30, window_batches=4, launches=launches,
        seconds_per_scene=seen["seconds"], voxels_per_second=float(np.prod(dims)) / seen["seconds"],
        cli_seconds=cli_seconds, max_memory_allocated=torch.cuda.max_memory_allocated(),
        covered_voxels=int(got.sum()), geo_iou=summary["geo_iou"], mean_iou=summary["mean_iou"],
        vis_files=len(os.listdir(os.path.join(out_dir, "vis"))),
    )

    # one window batch: kernels against the plain versions of the same layers
    gen = seen["generator"].eval()
    plain = state.make_generator(cfg, DEV, plain_convs=True).eval()
    plain.load_state_dict(gen.state_dict())
    pos = [(int(y), int(x)) for y, x in chunked.window_positions(dims[1:], 32)][8:16]
    sin = np.pad(seen["scene_input"], ((0, 0), (0, 64), (0, 64), (0, 0)))
    smask = np.pad(seen["scene_mask"], ((0, 0), (0, 64), (0, 64), (0, 0)))
    cb = torch.from_numpy(np.stack([sin[:, y:y + 64, x:x + 64] for y, x in pos])).to(DEV)
    mb = torch.from_numpy(np.stack([smask[:, y:y + 64, x:x + 64] for y, x in pos])).to(DEV)
    conv_ops.reset_launch_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.time()
        a = gen(cb, mb, pred_color=True, pred_semantic=True)
        torch.cuda.synchronize()
        rec["forward_seconds_window_batch"] = time.time() - t
        n_kernel = sum(conv_ops.launch_counts.values())
        b = plain(cb, mb, pred_color=True, pred_semantic=True)
        torch.cuda.synchronize()
    if n_kernel != 28 or sum(conv_ops.launch_counts.values()) != 28:
        raise SystemExit("chip_smoke: the plain-version generator launched a kernel, or the "
                         "other one did not")
    rec["window_batch_device_time"] = profile_window_batch(gen, cb, mb)
    diffs = {}
    rec["output_abs_max"] = {n: p.abs().max().item()
                             for n, p in zip(("occ", "sdf", "color", "semantic"), a)}
    for name, p, q in zip(("occ", "sdf", "color", "semantic"), a, b):
        d = (p - q).abs().max().item()
        if not (d <= 1e-3 and torch.isfinite(p).all()):
            raise SystemExit(f"chip_smoke: generator output {name}: kernels vs plain versions "
                             f"differ by {d:.3e}")
        diffs[name] = d
    rec["kernels_vs_plain_max_abs_diff"] = diffs
    del a, b, plain, gen, cb, mb
    torch.cuda.empty_cache()

    # a small scene, GPU against CPU (the reference the CPU tests hold to JAX)
    from spsg_tpu_torch.data import pipeline, synthetic

    small = TrainConfig(input_dim=(16, 16, 16), nf_gen=4)
    s = synthetic.make_scene(dims=(16, 40, 48), seed=4)
    sample = pipeline.assemble_sample(s.sdf_input, s.sdf_complete, s.input_colors, s.colors,
                                      s.semantics, s.known, s.world2grid, 3.0, "lab", None)
    args = (sample["input"], sample["mask"], sample["target_sdf"], sample["known"],
            sample["semantics"])
    kw = dict(chunk_dims=(16, 16, 16), stride=8, window_batch=4)
    g = state.init_generator(small, torch.Generator().manual_seed(0), "cpu")
    scale_conv_weights(g, 2.0)
    randomise_bn_statistics(g, 2)
    centre_occupancy_head(g, (16, 16, 16))
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = chunked.run_chunked_inference(g, *args, device=dev, **kw)
    same = outs["cuda"].counts == outs["cpu"].counts
    both = same & (outs["cpu"].counts > 0)
    sdf_diff = float(np.abs(outs["cuda"].sdf[both] - outs["cpu"].sdf[both]).max())
    # thresholded voxels a rounding away from a boundary may flip: a share
    if not (same.mean() >= 0.999 and both.sum() > 100 and sdf_diff <= 1e-3):
        raise SystemExit(f"chip_smoke: small scene, GPU vs CPU: counts agree on {same.mean():.5f}, "
                         f"sdf differs by {sdf_diff:.3e}")
    rec["small_scene_gpu_vs_cpu"] = dict(counts_agree=float(same.mean()), sdf_max_abs_diff=sdf_diff)
    emit("path", **rec)
    return launches


# --------------------------------------------------------------------------- main
def main():
    smi = phase_device()
    phase_build()
    results = phase_compare()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as tmp:
        launches = phase_path(tmp)

    kernels = []
    for name, replaces in KERNELS.items():
        head = next(r for r in results[name]["float32"]
                    if (r["shape"], r["cin"], r["cout"]) == (list(HEAVIEST[:4]), HEAVIEST[4], HEAVIEST[5]))
        if launches[name] < 1:
            raise SystemExit(f"chip_smoke: {name} was not launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces, launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in results[name]["float32"]),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            measured_at=dict(shape=head["shape"], cin=head["cin"], cout=head["cout"],
                             dtype="float32"),
            dtypes=results[name],
        ))
    print(smi, flush=True)  # again, so that it stands near the result whatever was printed above
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

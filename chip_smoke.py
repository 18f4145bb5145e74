#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spsg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device, nvcc, and nothing else (no network, no dataset, no
trained weights: everything is made from seeds). It exits with a code other
than 0, and without its last line, if there is no CUDA device or if any phase
fails. Phases, each printing one JSON line:

  device   the card (name and power limit as nvidia-smi gives them), versions
  build    builds the CUDA kernels from spsg_tpu_torch/ops/csrc with nvcc (one
           nvcc per source, started together); per kernel its registers and
           spills (ptxas) and its tensor-core instructions (HMMA, from
           cuobjdump -sass): every variant of the forward kernel and of the
           weight-gradient kernel must have some
  compare  (summary; the numbers are in the "kernels" line)
           every hand-written kernel against its plain PyTorch version, at a
           toy shape, an edge shape (ragged tiles, Cout > 104) and at the
           shapes the main paths give it (batch 1, and the (32,16,16) layer
           also at the paths' batches 8 and 2; the weight gradient also at the
           training batch's heaviest layer, (2,128,64,64) 100->40), in
           float32 and bfloat16, with times: kernel, plain version, the one
           library call that computes the same function (F.conv3d, or
           torch.nn.grad.conv3d_weight for the weight gradient, in true
           float32; a yardstick, the port never calls it for these layers),
           and the least time the card could take (bound: float32 work at
           three TF32 tensor-core passes, 3 x flops / 495 TFLOP/s, the least
           time in which the card gives a float32-accurate product; bfloat16
           at 989 TFLOP/s; or the bytes at 3.35 TB/s). The forward kernel
           also at the shapes the backward gives it (dx: Cin and Cout swapped,
           Cin of 1, 3 and 14). Then the full backward of both autograd
           Functions with the kernels against the same Functions with the
           plain versions inside, at the heaviest layer
  path     the serving path through the entry points a user calls: the
           whole-scene CLI at full width (nf_gen 20, windows (128,64,64),
           stride 32, window batch 8, colour and semantics) on one synthetic
           (128,160,192) scene with seeded random weights; checks the launch
           counters (23 fused + 5 bare convs per window batch, 4 batches), the
           outputs, IoU.txt; then one window batch with the kernels against
           the same batch with the kernels' plain versions, and a small scene
           on the GPU against the same scene on the CPU
  train    the training path: Trainer(TrainConfig()) at full width (nf_gen 20,
           chunks (128,64,64), batch 2, Adam) on synthetic chunks with seeded
           weights, 3D losses with colour and semantics switched on: the
           forward runs all 28 eligible convs, the backward crosses 25 of them
           (without 2D losses nothing reaches the three convs of the colour
           head, in the JAX package as here). One step with the kernels
           against the same step of a twin whose convs are the plain versions
           differentiated by autograd (metrics and every parameter gradient);
           launch counters per step (23 fused forward, 5 + 25 bare forward and
           dx, 25 dW; geometry-only flags: 9, 2 + 11, 11); three more steps
           (finite, parameters and running statistics move), timed; device
           time of one step by kind of kernel; a 16^3 / nf 4 step on the GPU
           against the same step on the CPU
  kernels  one line {"kernels": [...]}: per kernel its launches on the two
           paths and its numbers at the heaviest main-path shape, with every
           shape and both storage types nested under "dtypes"
  last     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Options (none when the script is run as the check of a checkout):
  --baseline-source PATH  another version of csrc/conv3x3.cu (e.g. the parent
           commit's, unpacked with git archive): built beside this one, and its
           K1 / K3 timed at every shape in turns with this one (baseline, this,
           this, baseline) through the same wrapper; "baseline_ms" per record
  --baseline-dw-source PATH  the same for csrc/conv3x3_dw.cu and K2

Tolerances. float32: |kernel - plain| <= 1e-4 on unit-variance outputs (both
accumulate in float32, in different orders; the forward kernel's 3xTF32
products are ~2^-20 relative); sums within rtol 1e-4. bfloat16:
both round the same float32 sum to bfloat16, so they differ only where the two
sums straddle a rounding boundary, by one step: <= 2e-2 for |y| < 4, and
2**-7 * |y| beyond; sums within rtol 1e-2. Weight gradient: within 1e-4
(float32) / 1e-2 (bfloat16 inputs: the plain version's product runs in another
precision) of the largest entry of dW; two runs bitwise equal. Backward of the
Functions, kernels against plain versions inside: dx, dW, db within 1e-4 of
their largest entry. Train step against the plain-conv twin: metrics within 1e-4
relative (also GPU against CPU at 16^3), each parameter gradient within 1e-2 of
its largest entry. The gradients' tolerance is not rounding of the backward: the
two forwards differ by float32 rounding (1e-5), which gives a few thousand of
the 1.5e9 activations, those within rounding of 0, the other LeakyReLU slope;
a weight gradient is a sum over N voxels of terms of either sign, of size
sqrt(N) terms, so k flipped terms move it by sqrt(k/N): 1e-3 to 2e-3 at the
(32,16,16) layers (N = 16384), where the largest differences are seen.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
from spsg_tpu_torch.training import StepFlags, TrainConfig  # noqa: E402
from spsg_tpu_torch.training import state  # noqa: E402
from spsg_tpu_torch.training.step import Trainer  # noqa: E402

DEV = torch.device("cuda:0")
T0 = time.time()

# NVIDIA H100 SXM data sheet, dense tensor-core rates and HBM3. float32 work is
# bounded as 3xTF32: three TF32 passes (hi*hi, hi*lo, lo*hi) are the least the
# card needs for a float32-accurate product, so its flops count three times
PEAK_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12}
PASSES = {torch.float32: 3, torch.bfloat16: 1}
BOUND_LABEL = {torch.float32: "3xTF32", torch.bfloat16: "bf16"}
PEAK_BYTES = 3.35e12

# name -> (source in this repo, TPU kernel it replaces)
KERNELS = {
    "conv3x3": ("spsg_tpu_torch/ops/csrc/conv3x3.cu", "spsg_tpu/ops/pallas_conv.py:127"),
    "conv3x3_act_stats": ("spsg_tpu_torch/ops/csrc/conv3x3.cu", "spsg_tpu/ops/pallas_conv.py:267"),
    "conv3x3_dw": ("spsg_tpu_torch/ops/csrc/conv3x3_dw.cu", "spsg_tpu/ops/pallas_conv.py:158"),
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
    (1, 128, 64, 64, 40, 40, True),    # decoder_3b, the second heaviest
    (1, 128, 64, 64, 40, 20, True),    # decoder_3c
    (1, 128, 64, 64, 25, 20, True),    # color_head_a, semantic_head_a
    (1, 64, 32, 32, 100, 40, True),    # decoder_2a
    (1, 64, 32, 32, 40, 40, True),     # decoder_2b, _2c, encoder_0c
    (8, 32, 16, 16, 100, 100, True),   # encoder_1b, _1c at the serving window batch
    (2, 32, 16, 16, 100, 100, True),   # ... and at the training batch
    (1, 6, 12, 20, 7, 130, False),     # edges: ragged tiles in X and Y, Cin and Cout of
                                       # 4-byte copies, Cout > 104 (N over two blocks)
]
HEAVIEST = SHAPES[2]
# what the backward gives the forward kernel (dx = conv of the cotangent with
# flipped weights, Cin and Cout swapped): decoder_3a, semantic_head_c,
# geo_occ_b / geo_3c, and color_head_c (on the path once the 2D colour losses
# are ported: the 3D losses do not reach the colour head)
DX_SHAPES = [
    (1, 128, 64, 64, 40, 100, True),
    (1, 128, 64, 64, 14, 20, True),
    (1, 128, 64, 64, 1, 10, True),
    (1, 128, 64, 64, 3, 10, False),
]
# the weight gradient alone at the training batch's heaviest layer (x: 420 MB)
DW_SHAPES = [(2, 128, 64, 64, 100, 40, True)]
FULL_3D = dict(pred_sdf=True, pred_color=True, pred_semantic=True)
# libraries of other versions of the kernels' sources (--baseline-source,
# --baseline-dw-source), by the key of ops/conv3x3.py's _libs
BASELINE = {}
GEO_ONLY = dict(pred_sdf=True, pred_color=False, pred_semantic=False)


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
    seconds = time.time() - t
    info = _build.BUILD_INFO
    sources = {}
    for n in _build.SOURCES:
        hmma = _build.sass_summary(n)
        kernels = _build.ptxas_summary(n)
        for k in kernels:
            k["hmma"] = hmma.get(k["kernel"], "not found") if "error" not in hmma else "not measured"
        sources[n] = dict(seconds=round(info[n]["seconds"], 2), cached=info[n]["cached"],
                          library=os.path.relpath(info[n]["path"]), ptxas=kernels,
                          sass_error=hmma.get("error"))
        if "error" not in hmma:
            # the forward and the weight-gradient kernels run on the tensor cores in
            # every variant
            kern = f"{n}_kernel"
            conv = {k: v for k, v in hmma.items() if kern in k}
            if not conv or not all(v > 0 for v in conv.values()):
                raise SystemExit(f"chip_smoke: {kern} variants without HMMA: "
                                 f"{[k for k, v in conv.items() if not v > 0] or 'none built'}")
    emit("build", seconds=round(seconds, 2), nvcc_flags=" ".join(_build.NVCC_FLAGS),
         sources=sources)


def load_baseline(src, key):
    """The library of another version of csrc/<key>.cu, built with the same
    flags and bound like the package's own."""
    t = time.time()
    bind = {"conv3x3": conv_ops._bind_conv, "conv3x3_dw": conv_ops._bind_dw}[key]
    lib = bind(ctypes.CDLL(_build.build_source(src, f"{key}_baseline")))
    emit("baseline", kernel=key, source=src, seconds=round(time.time() - t, 2))
    return lib


def time_kernel(fn, reps, rec, key="conv3x3"):
    """rec["ms"] of a call of the kernel of library ``key``; with a baseline
    of that library also rec["baseline_ms"], taken in turns (baseline, this,
    this, baseline) through the same wrapper."""
    if key not in BASELINE:
        rec["ms"] = cuda_ms(fn, reps)
        return

    def on_baseline():  # fn has run once already, so the package's library is loaded
        saved = conv_ops._libs[key]
        conv_ops._libs[key] = BASELINE[key]
        try:
            return cuda_ms(fn, reps)
        finally:
            conv_ops._libs[key] = saved

    turns = [on_baseline(), cuda_ms(fn, reps), cuda_ms(fn, reps), on_baseline()]
    rec.update(ms=(turns[1] + turns[2]) / 2, baseline_ms=(turns[0] + turns[3]) / 2,
               ms_turns=turns)


# --------------------------------------------------------------------------- compare
def bound(shape, dtype, weight_dtype=None):
    """Least time for a conv of this shape (forward, dx or dW: the same flops,
    the two volumes and the weights each moved once; float32 operations at
    three TF32 passes); dW is float32. Returns (ms, what bounds it, flops)."""
    B, Z, Y, X, Ci, Co = shape[:6]
    vox = B * Z * Y * X
    flops = 2.0 * 27 * Ci * Co * vox
    esize = torch.empty((), dtype=dtype).element_size()
    wsize = esize if weight_dtype is None else torch.empty((), dtype=weight_dtype).element_size()
    nbytes = vox * (Ci + Co) * esize + 27 * Ci * Co * wsize
    t_ops = PASSES[dtype] * flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
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


def compare_one(shape, dtype, gen, forward_only=False):
    """Kernels against plain versions at one shape: all three, or with
    ``forward_only`` conv3x3 alone. Returns {kernel name: record}."""
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
    time_kernel(lambda: conv_ops.conv3x3(x, w), reps, rec)
    rec["plain_ms"] = cuda_ms(lambda: conv_ops.conv3x3_plain(x, w), plain_reps)
    rec["library_ms"] = cuda_ms(lambda: F.conv3d(xc, wc, padding=1), reps)
    rec.update(bound_ms=bound_ms, bound_by=bound_by, bound_rate=BOUND_LABEL[dtype],
               tflops=flops / rec["ms"] / 1e9, eff=bound_ms / rec["ms"])
    out["conv3x3"] = rec
    del y, ref
    if forward_only:
        return out

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

    time_kernel(lambda: conv_ops.conv3x3_act_stats(x, w, b), reps, rec)
    rec["plain_ms"] = cuda_ms(lambda: conv_ops.conv3x3_act_stats_plain(x, w, b), plain_reps)
    rec["library_ms"] = cuda_ms(library, reps)
    rec.update(bound_ms=bound_ms, bound_by=bound_by, bound_rate=BOUND_LABEL[dtype],
               tflops=flops / rec["ms"] / 1e9, eff=bound_ms / rec["ms"])
    out["conv3x3_act_stats"] = rec
    out["conv3x3_dw"] = compare_dw(shape, dtype, gen, x, xc, reps, plain_reps, tag)
    return out


def compare_dw(shape, dtype, gen, x, xc, reps, plain_reps, tag):
    """conv3x3_dw against conv3x3_dw_plain on ``x`` (a (B,C,Z,Y,X) view of it
    in ``xc``) and a random cotangent."""
    B, Z, Y, X, Ci, Co, on_path = shape
    dy = torch.randn(B, Z, Y, X, Co, generator=gen).to(dtype).to(DEV)
    dyc = dy.permute(0, 4, 1, 2, 3)
    dw = conv_ops.conv3x3_dw(x, dy)
    torch.cuda.synchronize()
    ref = conv_ops.conv3x3_dw_plain(x, dy)
    rel = ((dw - ref).abs().max() / ref.abs().max()).item()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    if not (rel <= tol and dw.dtype == torch.float32 and torch.isfinite(dw).all()):
        raise SystemExit(f"chip_smoke: conv3x3_dw {tag}: kernel and plain version disagree "
                         f"(max err {rel:.3e} of max|dW|)")
    again = conv_ops.conv3x3_dw(x, dy)
    if not torch.equal(dw, again):
        raise SystemExit(f"chip_smoke: conv3x3_dw {tag}: two runs differ")
    bound_ms, bound_by, flops = bound(shape, dtype, weight_dtype=torch.float32)
    rec = dict(shape=list(shape[:4]), cin=Ci, cout=Co, main_path=on_path,
               max_abs_err=(dw - ref).abs().max().item(), max_rel_err=rel, repeats_bitwise=True)
    del dw, ref, again
    time_kernel(lambda: conv_ops.conv3x3_dw(x, dy), reps, rec, key="conv3x3_dw")
    rec["plain_ms"] = cuda_ms(lambda: conv_ops.conv3x3_dw_plain(x, dy), plain_reps)
    rec["library_ms"] = cuda_ms(
        lambda: torch.nn.grad.conv3d_weight(xc, (Co, Ci, 3, 3, 3), dyc, padding=1), reps)
    rec.update(bound_ms=bound_ms, bound_by=bound_by, bound_rate=BOUND_LABEL[dtype],
               tflops=flops / rec["ms"] / 1e9, eff=bound_ms / rec["ms"])
    return rec


def compare_dw_alone(shape, dtype, gen):
    """conv3x3_dw at a shape where only the weight gradient is compared."""
    B, Z, Y, X, Ci, Co, _ = shape
    x = torch.randn(B, Z, Y, X, Ci, generator=gen).to(dtype).to(DEV)
    tag = f"{tuple(shape[:4])} {Ci}->{Co} {str(dtype).split('.')[1]}"
    return compare_dw(shape, dtype, gen, x, x.permute(0, 4, 1, 2, 3), 5, 1, tag)


@contextlib.contextmanager
def plain_versions_inside():
    """Inside, the autograd Functions of ops/conv3x3.py take the plain versions
    on CUDA tensors too: the same backward algebra without the kernels."""
    saved = (conv_ops._conv, conv_ops._conv_act_stats, conv_ops.conv3x3_dw)
    conv_ops._conv = conv_ops.conv3x3_plain
    conv_ops._conv_act_stats = conv_ops.conv3x3_act_stats_plain
    conv_ops.conv3x3_dw = conv_ops.conv3x3_dw_plain
    try:
        yield
    finally:
        conv_ops._conv, conv_ops._conv_act_stats, conv_ops.conv3x3_dw = saved


def compare_backward(shape, gen):
    """Full backward of both Functions at ``shape``: kernels against the plain
    versions inside the same Functions, on the same graph, with all three
    cotangents of the fused function non-zero. Returns max errors relative to
    the largest entry of each gradient, and the device time of the
    dy_total -> dconv -> db pass, which is plain PyTorch in this version."""
    B, Z, Y, X, Ci, Co, _ = shape
    x = torch.randn(B, Z, Y, X, Ci, generator=gen).to(DEV).requires_grad_()
    w = (torch.randn(3, 3, 3, Ci, Co, generator=gen) / (27 * Ci) ** 0.5).to(DEV).requires_grad_()
    b = (0.1 * torch.randn(Co, generator=gen)).to(DEV).requires_grad_()
    cts = (torch.randn(B, Z, Y, X, Co, generator=gen).to(DEV),
           (0.1 * torch.randn(Co, generator=gen)).to(DEV),
           (0.01 * torch.randn(Co, generator=gen)).to(DEV))
    rec = {}
    for name, fn, leaves, ct in (
            ("conv3x3", conv_ops.conv3x3, (x, w), cts[0]),
            ("conv3x3_act_stats", conv_ops.conv3x3_act_stats, (x, w, b), cts)):
        # one forward (with the kernel), two backwards over the same graph: the
        # slope of the LeakyReLU is read from the saved activation, and a forward
        # of the plain version would differ in sign at the few voxels within
        # rounding of 0 (the forward is compared on its own, above)
        conv_ops.reset_launch_counts()
        outs = fn(*leaves)
        got = torch.autograd.grad(outs, leaves, ct, retain_graph=True)
        launched = dict(conv_ops.launch_counts)
        with plain_versions_inside():
            ref = torch.autograd.grad(outs, leaves, ct)
        del outs
        want = {"conv3x3": 1 + (name == "conv3x3"), "conv3x3_act_stats": int(name != "conv3x3"),
                "conv3x3_dw": 1}
        if launched != want or sum(conv_ops.launch_counts.values()) != sum(want.values()):
            raise SystemExit(f"chip_smoke: backward of {name}: launches {launched}, expected {want}")
        errs = {}
        for g, r, leaf in zip(got, ref, ("dx", "dw", "db")):
            errs[leaf] = ((g - r).abs().max() / r.abs().max()).item()
            if not errs[leaf] <= 1e-4:
                raise SystemExit(f"chip_smoke: backward of {name}: {leaf} differs from the "
                                 f"plain versions by {errs[leaf]:.3e} of its largest entry")
        rec[name] = errs
        del got, ref
    y = conv_ops.conv3x3_act_stats(x.detach(), w.detach(), b.detach())[0]

    def elementwise():
        dy_total = cts[0].float() + cts[1] + 2.0 * y.float() * cts[2]
        dconv = torch.where(y > 0, dy_total, 0.2 * dy_total).to(y.dtype)
        return dconv, dconv.float().sum(dim=(0, 1, 2, 3))

    rec["act_stats_backward_elementwise_ms"] = cuda_ms(elementwise, 5)
    return rec


def phase_compare():
    use_true_float32()
    gen = torch.Generator().manual_seed(0)
    results = {k: {"float32": [], "bfloat16": []} for k in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            for name, rec in compare_one(shape, dtype, gen).items():
                results[name][str(dtype).split(".")[1]].append(rec)
            torch.cuda.empty_cache()
        for shape in DX_SHAPES:
            rec = compare_one(shape, dtype, gen, forward_only=True)["conv3x3"]
            results["conv3x3"][str(dtype).split(".")[1]].append(dict(rec, role="dx"))
            torch.cuda.empty_cache()
        for shape in DW_SHAPES:
            results["conv3x3_dw"][str(dtype).split(".")[1]].append(
                compare_dw_alone(shape, dtype, gen))
            torch.cuda.empty_cache()
    backward = compare_backward(HEAVIEST, gen)
    torch.cuda.empty_cache()
    # the per-shape numbers go into the "kernels" line at the end
    emit("compare", tolerance={"float32": "abs 1e-4, sums rtol 1e-4, dW 1e-4 of max|dW|",
                               "bfloat16": "abs max(2e-2, 2**-7*|y|), sums rtol 1e-2, "
                                           "dW 1e-2 of max|dW|",
                               "backward": "dx, dW, db 1e-4 of their largest entry"},
         backward_kernels_vs_plain_inside=backward,
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


def classify(key):
    """Kind of a device kernel, from its name in the profiler's table."""
    k = key.lower()
    if "conv3x3_dw_kernel" in k:
        return "hand_dw"
    if "conv3x3_kernel" in k:
        return "hand_conv"
    if "reduce_partials" in k or "sum_slices" in k:
        return "hand_partial_reductions"
    if any(t in k for t in ("cudnn", "xmma", "convolve", "conv", "gemm", "cutlass", "wgrad", "dgrad")):
        return "library_conv"
    return "elementwise"


def device_time_by_kind(prof, rename):
    """Device microseconds of a torch.profiler run by kind of kernel (``rename``
    maps the kinds of ``classify`` to the names of one part of a program) and by
    kernel name."""
    groups, names = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        kind = classify(e.key)
        kind = rename.get(kind, kind)
        groups[kind] = groups.get(kind, 0.0) + us
        names[e.key] = names.get(e.key, 0.0) + us
    return groups, names


def device_time_record(groups, names, top):
    """The record of a profile; "not measured" if it shows no device time."""
    total = sum(groups.values())
    if total <= 0:
        return "not measured"
    first = sorted(names.items(), key=lambda kv: -kv[1])[:top]
    return dict(total_ms=total / 1e3, by_kind_ms={k: v / 1e3 for k, v in sorted(groups.items())},
                top_kernels_ms=[[k[:80], v / 1e3] for k, v in first])


def profile_window_batch(gen, cb, mb):
    """Device time of one window-batch forward by kind of kernel, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gen(cb, mb, pred_color=True, pred_semantic=True)
        torch.cuda.synchronize()
    groups = {"hand_conv3x3": 0.0, "hand_reduce_partials": 0.0, "library_conv": 0.0, "other": 0.0}
    measured, names = device_time_by_kind(prof, {
        "hand_conv": "hand_conv3x3", "hand_partial_reductions": "hand_reduce_partials",
        "elementwise": "other"})
    groups.update(measured)
    return device_time_record(groups, names, 8)


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

    want = {"conv3x3_act_stats": 23 * 4, "conv3x3": 5 * 4, "conv3x3_dw": 0}
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


# --------------------------------------------------------------------------- train
def profile_train_step(trainer, batch, flags):
    """Device time of one train step by kind of kernel, from torch.profiler:
    the step's three parts (forward and losses, backward, optimizer) traced one
    after the other, so that the forward kernel's launches for dx are told
    from its forward launches. "not measured" if the profiler shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    gen = trainer.generator.train()
    dev_batch = trainer._to_device(batch)
    trainer.optimizer.zero_grad(set_to_none=True)
    with profile(activities=acts) as p_fwd:
        loss, _ = trainer._forward_losses(dev_batch, flags)
        torch.cuda.synchronize()
    with profile(activities=acts) as p_bwd:
        loss.backward()
        torch.cuda.synchronize()
    for p in gen.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    with profile(activities=acts) as p_opt:
        trainer.optimizer.step()
        torch.cuda.synchronize()
    kinds, names = {}, {}
    for prof, rename in (
            (p_fwd, {"hand_conv": "hand_conv_forward", "library_conv": "library_conv_forward",
                     "elementwise": "elementwise_forward_and_losses"}),
            (p_bwd, {"hand_conv": "hand_conv_dx", "library_conv": "library_conv_backward",
                     "elementwise": "elementwise_backward"}),
            (p_opt, {k: "optimizer" for k in ("hand_conv", "library_conv", "elementwise")})):
        g, n = device_time_by_kind(prof, rename)
        for k, v in g.items():
            kinds[k] = kinds.get(k, 0.0) + v
        for k, v in n.items():
            names[k] = names.get(k, 0.0) + v
    return device_time_record(kinds, names, 10)


def rel_diff(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-12)


def compare_trainers(a, b, ma, mb, metric_tol, grad_tol, what):
    """Metrics and parameter gradients of two trainers after the same step.
    With ``grad_tol`` None the gradients' differences are reported, not held
    to a tolerance."""
    if set(ma) != set(mb):
        raise SystemExit(f"chip_smoke: {what}: metrics {sorted(ma)} vs {sorted(mb)}")
    mdiff = {k: rel_diff(ma[k], mb[k]) for k in ma}
    bad = {k: v for k, v in mdiff.items() if not v <= metric_tol}
    if bad or not all(np.isfinite(float(v)) for v in ma.values()):
        raise SystemExit(f"chip_smoke: {what}: metrics differ: {bad}, {ma} vs {mb}")
    reached, noise, errs = 0, [], []
    pb = dict(b.generator.named_parameters())
    largest = max(p.grad.abs().max().item() for p in pb.values())
    for name, p in a.generator.named_parameters():
        g, r = p.grad.float().cpu(), pb[name].grad.float().cpu()
        scale = r.abs().max().item()
        if scale <= 1e-6 * largest:
            # no gradient (the colour head without 2D losses), or one that is zero in
            # exact arithmetic and rounding noise in float32 (the bias of a conv that
            # feeds only train-mode BatchNorm): that small on both sides
            if not g.abs().max().item() <= 1e-6 * largest:
                raise SystemExit(f"chip_smoke: {what}: {name} has a gradient on one side only")
            if scale > 0.0:
                noise.append(name)
            continue
        reached += 1
        err = (g - r).abs().max().item() / scale
        errs.append((err, name))
    worst, worst_name = max(errs)
    if grad_tol is not None and not worst <= grad_tol:
        raise SystemExit(f"chip_smoke: {what}: gradient of {worst_name} differs by {worst:.3e} "
                         f"of its largest entry; worst five {sorted(errs)[-5:]}, median "
                         f"{sorted(errs)[len(errs) // 2][0]:.3e}")
    return dict(metrics_max_rel_diff=max(mdiff.values()), grad_max_rel_diff=worst,
                grad_worst_parameter=worst_name, parameters_with_gradient=reached,
                grad_median_rel_diff=sorted(errs)[len(errs) // 2][0],
                grad_worst_five=[[n, e] for e, n in sorted(errs)[-5:]],
                gradients_of_rounding_noise=noise)


def centre_train_occupancy(trainer, batch):
    """The loss is masked to voxels the model predicts occupied; with random
    weights those may be none. Shift the occupancy head's bias by the median
    train-mode logit of this batch, so that half of the voxels count."""
    dev_batch = trainer._to_device(batch)
    gen = trainer.generator.train()
    with torch.no_grad():
        occ_l = gen(dev_batch["input"], dev_batch["mask"], pred_color=False)[0]
        gen.geo_occ_b.bias -= occ_l.median()


def phase_train():
    from spsg_tpu_torch.data import synthetic

    cfg = TrainConfig()  # reference defaults: nf_gen 20, (128,64,64), batch 2, lr 1e-4, Adam
    batch = synthetic.make_chunk_batch(cfg.batch_size, cfg.input_dim, seed=7)
    batch.pop("name")
    batch["weight_occ"] = np.float32(1.0)
    full, geo = StepFlags(**FULL_3D), StepFlags(**GEO_ONLY)

    trainer = Trainer(cfg, DEV, seed=0)
    scale_conv_weights(trainer.generator, 2.0)
    centre_train_occupancy(trainer, batch)
    twin = Trainer(cfg, DEV, seed=0, plain_convs=True)
    twin.generator.load_state_dict(trainer.generator.state_dict())
    before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}

    # (a) one step with the kernels, and the same step with the plain versions
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    conv_ops.reset_launch_counts()
    metrics = trainer.step(batch, full)
    torch.cuda.synchronize()
    launches = dict(conv_ops.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    twin_metrics = twin.step(batch, full)
    torch.cuda.synchronize()
    twin_peak = torch.cuda.max_memory_allocated()
    if dict(conv_ops.launch_counts) != launches:
        raise SystemExit("chip_smoke: the plain-conv twin launched a kernel")
    # (b) launch counters of one step: 28 eligible convs forward, 25 backward (the
    # three convs of the colour head have no loss without the 2D terms)
    want = {"conv3x3_act_stats": 23, "conv3x3": 5 + 25, "conv3x3_dw": 25}
    if launches != want:
        raise SystemExit(f"chip_smoke: launches of one train step {launches}, expected {want}")
    rec = dict(config=dict(nf_gen=cfg.nf_gen, input_dim=list(cfg.input_dim),
                           batch_size=cfg.batch_size, lr=cfg.lr, flags=FULL_3D),
               launches_per_step=dict(launches), max_memory_allocated=peak,
               twin_max_memory_allocated=twin_peak,
               first_step_metrics={k: float(v) for k, v in metrics.items()},
               kernels_vs_plain_twin=compare_trainers(trainer, twin, metrics, twin_metrics,
                                                      1e-4, 1e-2, "train step vs plain-conv twin"))
    if not (metrics["loss_occ"] > 0 and metrics["loss_sdf"] > 0 and metrics["loss_semantic"] > 0
            and 0 < metrics["iou_occ"] < 1):
        raise SystemExit(f"chip_smoke: the first step's losses are degenerate: {metrics}")
    del twin
    torch.cuda.empty_cache()

    # (c) three more steps, timed
    seconds, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        m = trainer.step(batch, full)
        torch.cuda.synchronize()
        seconds.append(time.time() - t)
        losses.append({k: float(v) for k, v in m.items()})
    after = trainer.generator.state_dict()
    finite = all(np.isfinite(v) for m in losses for v in m.values()) and all(
        torch.isfinite(v).all() for v in after.values())
    changed = [k for k, v in after.items() if not torch.equal(v, before[k])]
    unchanged = sorted(set(after) - set(changed))
    if not finite or trainer.iteration != 4:
        raise SystemExit(f"chip_smoke: training steps gave non-finite values: {losses}")
    # without 2D losses nothing reaches the colour head: with no weight decay it stays
    moved = (after["decoder_3a.bn.running_mean"] - before["decoder_3a.bn.running_mean"]).abs().max()
    if not (moved > 0 and "geo_0a.weight" in changed and "semantic_head_c.weight" in changed
            and set(unchanged) <= set(k for k in after if k.startswith("color_head_"))):
        raise SystemExit(f"chip_smoke: parameters that should move did not: unchanged {unchanged}")
    rec.update(seconds_per_step=sorted(seconds)[1], seconds_per_step_all=seconds,
               losses=[m["loss"] for m in losses], tensors_changed=len(changed),
               tensors_unchanged=unchanged)

    # geometry-only flags: the same code at a smaller depth
    conv_ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.time()
    gm = trainer.step(batch, geo)
    torch.cuda.synchronize()
    geo_seconds = time.time() - t
    want = {"conv3x3_act_stats": 9, "conv3x3": 2 + 11, "conv3x3_dw": 11}
    if dict(conv_ops.launch_counts) != want:
        raise SystemExit(f"chip_smoke: launches of one geometry-only step "
                         f"{conv_ops.launch_counts}, expected {want}")
    if set(gm) != {"loss_occ", "iou_occ", "loss_sdf", "loss"} or not all(
            np.isfinite(float(v)) for v in gm.values()):
        raise SystemExit(f"chip_smoke: geometry-only step: {gm}")
    for k, v in conv_ops.launch_counts.items():
        launches[k] += v
    rec.update(geo_only=dict(launches_per_step=want, seconds=geo_seconds,
                             metrics={k: float(v) for k, v in gm.items()}))
    # a validation pass changes nothing
    state_before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    vm = trainer.step(batch, StepFlags(train=False, **FULL_3D))
    if trainer.iteration != 5 or not all(
            torch.equal(v, state_before[k]) for k, v in trainer.generator.state_dict().items()):
        raise SystemExit("chip_smoke: the validation pass changed the model")
    rec["validation_metrics"] = {k: float(v) for k, v in vm.items()}
    del state_before

    rec["step_device_time"] = profile_train_step(trainer, batch, full)

    # the same step with cuDNN choosing the algorithms of the 7 library convs by trial
    # (torch.backends.cudnn.benchmark), which the port does not switch on: a reading for
    # PERF.md of how much of the library convs' backward is cuDNN's default choice
    torch.backends.cudnn.benchmark = True
    try:
        seconds = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.time()
            trainer.step(batch, full)
            torch.cuda.synchronize()
            seconds.append(time.time() - t)
    finally:
        torch.backends.cudnn.benchmark = False
    rec["seconds_per_step_cudnn_benchmark"] = dict(first=seconds[0],
                                                   median_of_last_three=sorted(seconds[2:])[1])
    del trainer
    torch.cuda.empty_cache()

    # (d) a small step on the GPU against the same step on the CPU
    small = TrainConfig(input_dim=(16, 16, 16), nf_gen=4)
    sbatch = synthetic.make_chunk_batch(2, (16, 16, 16), seed=1)
    sbatch.pop("name")
    sbatch["weight_occ"] = np.float32(1.0)
    pair = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(small, dev, seed=3)
        scale_conv_weights(tr.generator, 2.0)
        pair[dev] = (tr, tr.step(sbatch, full))
    # gradients are reported only: at this size the loss sits on a few hundred voxels,
    # and one of them taking the other LeakyReLU slope (an activation within rounding
    # of 0) moves a gradient by percents (seen: 13 %); without such a voxel they agree
    # to 1e-5. The kernels' backward is held to 1e-4 in the compare phase.
    rec["small_step_gpu_vs_cpu"] = compare_trainers(
        pair["cuda"][0], pair["cpu"][0], pair["cuda"][1], pair["cpu"][1], 1e-4, None,
        "16^3 step, GPU vs CPU")
    emit("train", **rec)
    return launches


# --------------------------------------------------------------------------- main
def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke test of spsg_tpu_torch on one GPU.")
    ap.add_argument("--baseline-source", default=None,
                    help="another version of csrc/conv3x3.cu to time beside this one")
    ap.add_argument("--baseline-dw-source", default=None,
                    help="another version of csrc/conv3x3_dw.cu to time beside this one")
    args = ap.parse_args(argv)
    smi = phase_device()
    phase_build()
    for key, src in (("conv3x3", args.baseline_source),
                     ("conv3x3_dw", args.baseline_dw_source)):
        if src:
            BASELINE[key] = load_baseline(src, key)
    results = phase_compare()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as tmp:
        serve = phase_path(tmp)
    train = phase_train()

    # the kernels of each path: serving runs the two forward kernels, training all three
    on_path = {"serve": ("conv3x3", "conv3x3_act_stats"), "train": tuple(KERNELS)}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        head = next(r for r in results[name]["float32"]
                    if (r["shape"], r["cin"], r["cout"]) == (list(HEAVIEST[:4]), HEAVIEST[4], HEAVIEST[5]))
        by_path = {"serve": serve[name], "train": train[name]}
        for path, names in on_path.items():
            if name in names and by_path[path] < 1:
                raise SystemExit(f"chip_smoke: {name} was not launched on the {path} path")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
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

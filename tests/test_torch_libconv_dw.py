"""The library convs' weight gradient (spsg_tpu_torch/ops/libconv_dw.py and its
kernel libconv_dw_kernel in ops/csrc/conv3x3_dw.cu) on the CPU at 16^3, nf 4.

The kernel computes dW (K^3*Cin, Cout) = patches^T . dy over the output voxels
in tiles of TY x TX voxels of one (b, z) plane, each walked row by row in k8
steps of 8 voxels along x; every k8 step is three mma passes of 3xTF32 split
operands (lo*hi, hi*lo, hi*hi, each sum rounded toward zero, as the tensor core
leaves it), summed in temporaries from 0 that join float32 accumulators once a
tile; the voxel shares' slices are added in order. ``kernel_order_dw`` emulates
that order of sums and is held to the float64 dW. The generator routes its
library convs through the Function in float32 training only; the step counts
them (``train.libconv_dw``); the benchmark files the kernels under library convs."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu_torch.data import synthetic
from spsg_tpu_torch.models import generator as tg
from spsg_tpu_torch.models.convert import generator_grads_to_flax
from spsg_tpu_torch.ops import libconv_dw as L
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training.step import Trainer
from spsg_tpu_torch.utils import timing

import torch_port_helpers as H
from test_torch_conv3x3_dw_tf32 import split, tf32, to_float32_toward_zero

NF = 4
FULL, HALF = (16, 16, 16), (8, 8, 8)
# the seven library convs at nf 4: (input extent, Cin, Cout, kernel, stride, padding)
LAYERS = {
    "geo_0a": (FULL, 1, NF // 2, 5, 1, 2),
    "geo_0b": (FULL, NF // 2, NF, 4, 2, 1),
    "geo_1a": (HALF, NF, 2 * NF, 4, 2, 1),
    "encoder_0a": (FULL, 4, NF, 5, 1, 2),
    "encoder_0b": (FULL, NF, 2 * NF, 4, 2, 1),
    "encoder_geo": (FULL, NF, NF, 4, 2, 1),
    "encoder_1a": (HALF, 3 * NF, 5 * NF, 4, 2, 1),
}
KW = dict(pred_color=True, pred_sdf=True, pred_semantic=True)


def patches(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """(B,Z,Y,X,Cin) -> (B,OZ,OY,OX,K^3*Cin): the input each output voxel's taps
    read, tap-major in (kz, ky, kx) order, then the input channel: the rows of
    the kernel's A operand, one voxel a column."""
    xp = F.pad(x, (0, 0, p, p, p, p, p, p))
    o = [(n + 2 * p - k) // s + 1 for n in x.shape[1:4]]
    return torch.cat([xp[:, kz:kz + s * (o[0] - 1) + 1:s, ky:ky + s * (o[1] - 1) + 1:s,
                         kx:kx + s * (o[2] - 1) + 1:s]
                      for kz in range(k) for ky in range(k) for kx in range(k)], dim=-1)


def tiles_of(t: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """(B,OZ,OY,OX,C) -> (tiles, TY*TX/8, 8, C): the voxels in the order the
    kernel walks them, tile by tile ((b, z, tile row, tile column)), and in a
    tile row by row in k8 steps of 8 voxels along x; the voxels past the volume
    that a tile covers are zeros."""
    B, Z, Y, X, C = t.shape
    t = F.pad(t, (0, 0, 0, -X % tx, 0, -Y % ty))
    Y, X = t.shape[2], t.shape[3]
    t = t.reshape(B, Z, Y // ty, ty, X // tx, tx, C).permute(0, 1, 2, 4, 3, 5, 6)
    return t.reshape(-1, ty * tx // 8, 8, C)


def tile_shape(out, stride):
    """The kernel's voxel tile (TY, TX): 16 voxels along x (8 where OX < 16),
    128 voxels a tile at stride 1 and 64 at stride 2, at most OY rows."""
    tx = 16 if out[2] >= 16 else 8
    return min((128 if stride == 1 else 64) // tx, out[1]), tx


def kernel_order_dw(x, dy, k, s, p, shares):
    """dW (K^3*Cin, Cout) as the kernel sums it: per k8 step three mma passes
    (lo*hi', hi*lo', hi*hi'), each an exact sum rounded toward zero to float32;
    the passes of a tile in temporaries from 0 joined to the float32
    accumulators by a rounded add; the tiles of a share in order, its share
    from tiles * s // shares; the shares' slices added in order."""
    ty, tx = tile_shape(dy.shape[1:4], s)
    a = tiles_of(patches(x.double(), k, s, p).float(), ty, tx)
    b = tiles_of(dy, ty, tx)
    (ah, al), (bh, bl) = split(a), split(b)
    ah, al, bh, bl = ah.double(), al.double(), bh.double(), bl.double()
    n_tiles, steps = a.shape[0], a.shape[1]
    d = torch.zeros(n_tiles, a.shape[-1], b.shape[-1], dtype=torch.float64)
    for i in range(steps):
        for pa, pb in ((al, bh), (ah, bl), (ah, bh)):
            d = to_float32_toward_zero(d + pa[:, i].transpose(1, 2) @ pb[:, i]).double()
    d = d.float()
    out = torch.zeros(a.shape[-1], b.shape[-1], dtype=torch.float32)
    for share in range(shares):
        acc = torch.zeros_like(out)
        for t in range(n_tiles * share // shares, n_tiles * (share + 1) // shares):
            acc = acc + d[t]
        out = out + acc
    return out


def layer_data(name, batch=2, seed=0):
    dims, cin, cout, k, s, p = LAYERS[name]
    out = tuple((n + 2 * p - k) // s + 1 for n in dims)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch,) + dims + (cin,)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((batch,) + out + (cout,)).astype(np.float32))
    return x, dy, k, s, p


def dw64(x, dy, k, s, p):
    """float64 dW in PyTorch's layout (Cout, Cin, K, K, K)."""
    return torch.nn.grad.conv3d_weight(
        x.double().permute(0, 4, 1, 2, 3), (dy.shape[4], x.shape[4], k, k, k),
        dy.double().permute(0, 4, 1, 2, 3), s, p)


def as_torch_layout(dw, k, cin, cout):
    """(K^3*Cin, Cout), rows tap-major, -> (Cout, Cin, K, K, K)."""
    return dw.reshape(k, k, k, cin, cout).permute(4, 3, 0, 1, 2)


@pytest.mark.parametrize("name", list(LAYERS))
def test_the_kernels_order_of_sums_reproduces_the_float64_dw(name):
    """At each of the seven layer forms, with 1 and 3 voxel shares: the
    emulated kernel within 1e-5 of max|dW| of the float64 dW, and the plain
    version (the CPU path) within 1e-5 too."""
    x, dy, k, s, p = layer_data(name)
    ref = dw64(x, dy, k, s, p)
    scale = ref.abs().max()
    for shares in (1, 3):
        got = as_torch_layout(kernel_order_dw(x, dy, k, s, p, shares), k, x.shape[4], dy.shape[4])
        err = ((got.double() - ref).abs().max() / scale).item()
        assert err <= 1e-5, (shares, err)
    plain = L.libconv_dw(x, dy, k, s, p)
    assert plain.shape == ref.shape and plain.dtype == torch.float32
    assert ((plain.double() - ref).abs().max() / scale).item() <= 1e-5


def test_one_tf32_pass_is_outside_the_float32_tolerance():
    """Why three passes: one pass of TF32 operands at the heaviest form is off
    by more than 1e-4 of max|dW|."""
    x, dy, k, s, p = layer_data("encoder_0a", seed=3)
    ref = dw64(x, dy, k, s, p)
    err = ((dw64(tf32(x), tf32(dy), k, s, p) - ref).abs().max() / ref.abs().max()).item()
    assert err > 1e-4, err


def test_the_tile_order_covers_every_voxel_once():
    for name in ("geo_0a", "geo_1a"):
        _, dy, k, s, p = layer_data(name)
        ids = torch.arange(1, dy[..., :1].numel() + 1, dtype=torch.float32).reshape(dy[..., :1].shape)
        order = tiles_of(ids, *tile_shape(ids.shape[1:4], s)).flatten()
        order = order[order > 0]
        assert torch.equal(order.sort().values, ids.flatten())


def test_the_function_gives_the_librarys_forward_and_gradients():
    """library_conv against F.conv3d's autograd on the same channel-last
    tensors: forward, dx and dW to the bit on the CPU (the same library calls)."""
    rng = np.random.default_rng(1)
    for name in ("encoder_0a", "encoder_1a"):
        dims, cin, cout, k, s, p = LAYERS[name]
        x = torch.from_numpy(rng.standard_normal((2,) + dims + (cin,)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((cout, cin, k, k, k)).astype(np.float32))
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
        ya = L.library_conv(xa, wa, s, p)
        yb = F.conv3d(xb.permute(0, 4, 1, 2, 3), wb, None, s, p).permute(0, 2, 3, 4, 1)
        g = torch.from_numpy(rng.standard_normal(tuple(ya.shape)).astype(np.float32))
        (ya * g).sum().backward()
        (yb * g).sum().backward()
        assert torch.equal(ya, yb) and torch.equal(xa.grad, xb.grad), name
        assert torch.equal(wa.grad, wb.grad), name


def _inputs():
    rng = np.random.default_rng(5)
    x = rng.uniform(-3, 3, (2,) + FULL + (4,)).astype(np.float32)
    m = (rng.random((2,) + FULL + (1,)) > 0.5).astype(np.float32)
    return x, m


def test_generator_gradients_through_the_function_match_jax():
    """The port's generator in train mode (its seven library convs through the
    Function) against the JAX package's gradients of the same loss."""
    v = H.initial_variables()
    x, m = _inputs()
    jgen = JaxGenerator(JaxGeneratorConfig(nf=NF))

    def loss(params):
        outs, _ = jgen.apply({"params": params, "batch_stats": v["batch_stats"]}, x, m,
                             train=True, mutable=["batch_stats"], **KW)
        return sum(jnp.mean(o ** 2) for o in outs)

    ref = jax.tree_util.tree_flatten_with_path(H.to_numpy_tree(jax.jit(jax.grad(loss))(v["params"])))[0]
    gen = H.torch_generator(v).train()
    timing.enable()
    try:
        outs = gen(H.t(x), H.t(m), **KW)
        sum((o ** 2).mean() for o in outs).backward()
    finally:
        timing.disable()
    assert timing.drain()["counts"] == {"train.libconv_dw": 7}
    got = {jax.tree_util.keystr(k): np.asarray(a) for k, a in
           jax.tree_util.tree_flatten_with_path(generator_grads_to_flax(gen))[0]}
    assert set(got) == {jax.tree_util.keystr(k) for k, _ in ref}
    for k, r in ref:
        key = jax.tree_util.keystr(k)
        r = np.asarray(r)
        np.testing.assert_allclose(got[key], r, rtol=0, atol=5e-4 * np.abs(r).max() + 2e-7,
                                   err_msg=key)


def _function_calls(monkeypatch, gen, train, grad):
    """The layers whose forward took library_conv, in one forward of ``gen``."""
    seen = []
    real = tg.library_conv

    def spy(x, w, stride, padding):
        seen.append(next(n for n, b in gen.named_modules() if getattr(b, "weight", None) is w))
        return real(x, w, stride, padding)

    monkeypatch.setattr(tg, "library_conv", spy)
    x, m = (H.t(a[:1]) for a in _inputs())
    gen.train(train)
    with torch.set_grad_enabled(grad):
        gen(x, m, **KW)
    return seen


SEVEN = ["geo_0a", "geo_0b", "geo_1a", "encoder_0a", "encoder_0b", "encoder_geo", "encoder_1a"]


@pytest.mark.parametrize("case,want", [
    ("train", SEVEN),
    ("eval", []),
    ("no_grad", []),
    ("bfloat16", []),
    ("zslab_conv", []),
    ("folded_conv", [n for n in SEVEN if n not in ("geo_0a", "encoder_0a")]),
    ("max_dilation2", SEVEN),
    ("plain_convs", []),
])
def test_routing_takes_the_function_in_float32_training_only(monkeypatch, case, want):
    """Float32 training takes the Function on all seven library convs; eval, no
    grad and bf16 keep F.conv3d; the z-slab forms keep their layers; geo_1d at
    dilation 2 keeps F.conv3d; the plain_convs hook runs no hand kernel."""
    cfg = {"bfloat16": dict(dtype="bfloat16"), "zslab_conv": dict(zslab_conv=True),
           "folded_conv": dict(folded_conv=True), "max_dilation2": dict(max_dilation=2)}
    gen = H.torch_generator(H.initial_variables(), **cfg.get(case, {}))
    if case == "plain_convs":
        gen = tg.Generator(gen.cfg, plain_convs=True)
    got = _function_calls(monkeypatch, gen, train=case != "eval", grad=case != "no_grad")
    assert got == want
    if case == "max_dilation2":
        assert gen.geo_1d.route == "library" and not gen.geo_1d.hand_dw(torch.float32)


def test_the_entry_convs_compute_no_input_gradient(monkeypatch):
    """geo_0a and encoder_0a (the 5^3 convs) read the data: their backward
    computes dW alone; the five downsamplers compute dx too."""
    seen = []
    real = L._LibraryConv.backward

    def spy(ctx, dy):
        dx, dw, _, _ = real(ctx, dy)
        seen.append((ctx.saved_tensors[1].shape[2], dx is None, dw is None))
        return dx, dw, None, None

    monkeypatch.setattr(L._LibraryConv, "backward", staticmethod(spy))
    x, m = (H.t(a) for a in _inputs())
    gen = H.torch_generator(H.initial_variables()).train()
    sum((o ** 2).mean() for o in gen(x, m, **KW)).backward()
    assert sorted(seen) == [(4, False, False)] * 5 + [(5, True, False)] * 2


@pytest.mark.parametrize("remat", [False, True])
def test_a_trainer_step_counts_seven_hand_weight_gradients(remat):
    """``train.libconv_dw`` reads 7 a step of the CPU Trainer, also with remat
    (a rematerialised block's recompute counts nothing)."""
    trainer = Trainer(TrainConfig(input_dim=FULL, nf_gen=NF, remat=remat), device="cpu")
    batch = dict(synthetic.make_chunk_batch(2, FULL, seed=1), weight_occ=1.0)
    flags = StepFlags(pred_sdf=True, pred_color=True, pred_semantic=True)
    timing.enable()
    try:
        trainer.step(batch, flags)
        trainer.step(batch, flags)
    finally:
        timing.disable()
    counts = timing.drain()["counts"]
    assert counts["train.steps"] == 2 and counts["train.libconv_dw"] == 14


def test_the_benchmark_files_both_kernels_under_library_convs():
    bench = os.path.join(H.REPO, "benchmark")
    sys.path.insert(0, bench)
    try:
        from lib import layers
    finally:
        sys.path.remove(bench)
    classify = layers.classifier(bench)
    for name in ("void (anonymous namespace)::libconv::libconv_dw_kernel<4, 3>(float const*, "
                 "float const*, float*, (anonymous namespace)::libconv::Plan)",
                 "(anonymous namespace)::libconv::libconv_dw_join_kernel(float const*, int, int, "
                 "int, int, float*)"):
        assert classify(name) == "library convs", name
    assert classify("void (anonymous namespace)::conv3x3_dw_kernel<float, 5>(float const*)") \
        == "hand convs K1-K3"


def test_a_bf16_step_counts_zero_hand_weight_gradients():
    """A training step whose library convs keep the library's weight gradient
    (the generator in bf16) counts ``train.libconv_dw`` at 0: the counter is
    there, and reads 0, wherever the generator trains."""
    trainer = Trainer(TrainConfig(input_dim=FULL, nf_gen=NF, compute_dtype="bfloat16"),
                      device="cpu")
    batch = dict(synthetic.make_chunk_batch(2, FULL, seed=1), weight_occ=1.0)
    timing.enable()
    try:
        trainer.step(batch, StepFlags(pred_sdf=True, pred_color=True, pred_semantic=True))
    finally:
        timing.disable()
    counts = timing.drain()["counts"]
    assert counts["train.steps"] == 1 and counts["train.libconv_dw"] == 0


@pytest.mark.parametrize("counts,want", [
    ({"train.steps": 2, "train.libconv_dw": 14}, 7.0),
    ({"train.steps": 2, "train.libconv_dw": 0}, 0.0),
    ({"train.steps": 2}, None),
])
def test_the_hand_dw_metric_reads_the_counter_over_the_steps(counts, want):
    """``libconv.hand_dw.train``: 7 a step where all seven take the hand dW, 0
    where the port counts none, nothing where the port has no such counter."""
    import importlib.util

    bench = os.path.join(H.REPO, "benchmark")
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location(
            "hand_dw_reader", os.path.join(bench, "metrics", "libconv.hand_dw.train.py"))
        reader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reader)
    finally:
        sys.path.remove(bench)
    assert reader.read({"program": {"spans": [], "counts": counts}}) == want

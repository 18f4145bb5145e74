"""The numeric design of the weight-gradient kernel (spsg_tpu_torch/ops/csrc/conv3x3_dw.cu),
emulated on the CPU in torch alone.

The kernel computes dW (27*Cin, Cout) = patches^T . dy as a GEMM whose
reduction runs over the voxels, 10^5-10^6 long on the generator's layers. float32
storage is computed on TF32 tensor cores as three passes (lo*hi + hi*lo + hi*hi
of a split v = hi + lo, hi and lo truncated to TF32), bfloat16 as one. The
tensor core rounds each mma's sum toward zero (it truncates as it accumulates),
so the kernel sums the passes of one voxel tile (16 k8 steps of 8 voxels) in
temporaries that start at 0, adds them to float32 accumulators with a rounded
add, and adds the S per-block slices in order. These tests hold that design
against the float64 dW."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

LOW13 = -(1 << 13)  # int32 mask that clears the 13 low bits (0xffffe000)
TY, TX = 8, 16      # the kernel's voxel tile on planes with X >= 16: 16 k8 steps
SHAPE = (2, 16, 32, 32)


def tf32(v: torch.Tensor, mode: str = "truncate") -> torch.Tensor:
    """float32 -> the TF32 value as float32: low 13 bits cleared, after adding
    half an ulp of TF32 for ``rna`` (finite inputs)."""
    bits = v.contiguous().view(torch.int32)
    if mode == "rna":
        bits = bits + (1 << 12)
    return (bits & LOW13).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def patches(x: torch.Tensor) -> torch.Tensor:
    """(B,Z,Y,X,Cin) -> (B,Z,Y,X,27*Cin) float64, tap-major in (dz, dy, dx)
    order: the rows of the kernel's A operand, one voxel a column."""
    _, Z, Y, X, _ = x.shape
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1, 1, 1))
    return torch.cat([xp[:, dz:dz + Z, dy:dy + Y, dx:dx + X]
                      for dz in range(3) for dy in range(3) for dx in range(3)], dim=-1)


def dw64(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """float64 dW (27*Cin, Cout)."""
    return patches(x).reshape(-1, 27 * x.shape[-1]).t() @ dy.double().reshape(-1, dy.shape[-1])


def data(cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE + (cin,)).astype(np.float32)
    dy = rng.standard_normal(SHAPE + (cout,)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(dy)


def to_float32_toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero, as the tensor core leaves an mma's sum."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def tile_steps(t: torch.Tensor) -> torch.Tensor:
    """(B,Z,Y,X,C) -> (tiles, 16, 8, C): the voxels in the order the kernel
    walks them, tile by tile ((b, z, tile row, tile column)), and within a tile
    row by row in k8 steps of 8 voxels along x."""
    B, Z, Y, X, C = t.shape
    t = t.reshape(B, Z, Y // TY, TY, X // TX, TX, C).permute(0, 1, 2, 4, 3, 5, 6)
    return t.reshape(-1, TY * TX // 8, 8, C)


def kernel_order_dw(x, dy, shares, tile_temporaries=True):
    """dW as the kernel sums it (float32 storage): per k8 step three mma passes
    (lo*hi', hi*lo', hi*hi'), each an exact sum rounded toward zero to float32;
    the passes of a tile in temporaries from 0 joined to the float32
    accumulators by a rounded add (or, with ``tile_temporaries`` False, one
    accumulator across the whole share); the share's slices added in order."""
    a = tile_steps(patches(x).float())          # (tiles, 16, 8, 27*Cin)
    b = tile_steps(dy)                          # (tiles, 16, 8, Cout)
    (ah, al), (bh, bl) = split(a), split(b)
    ah, al, bh, bl = ah.double(), al.double(), bh.double(), bl.double()
    tiles = a.shape[0]
    per_share = tiles // shares
    m, n = a.shape[-1], b.shape[-1]
    if tile_temporaries:
        d = torch.zeros(tiles, m, n, dtype=torch.float64)
        for k in range(a.shape[1]):
            for pa, pb in ((al, bh), (ah, bl), (ah, bh)):
                d = to_float32_toward_zero(d + pa[:, k].transpose(1, 2) @ pb[:, k]).double()
        d = d.float().reshape(shares, per_share, m, n)
        acc = torch.zeros(shares, m, n, dtype=torch.float32)
        for i in range(per_share):
            acc = acc + d[:, i]
    else:
        steps = lambda t: t.reshape(shares, per_share * t.shape[1], 8, t.shape[-1])  # noqa: E731
        ah, al, bh, bl = steps(ah), steps(al), steps(bh), steps(bl)
        acc = torch.zeros(shares, m, n, dtype=torch.float64)
        for k in range(ah.shape[1]):
            for pa, pb in ((al, bh), (ah, bl), (ah, bh)):
                acc = to_float32_toward_zero(acc + pa[:, k].transpose(1, 2) @ pb[:, k]).double()
        acc = acc.float()
    out = torch.zeros(m, n, dtype=torch.float32)
    for s in range(shares):
        out = out + acc[s]
    return out


def rel_err(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def test_rounding_toward_zero_emulation():
    v = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 1.0 - 2.0 ** -40, 3.0],
                     dtype=torch.float64)
    got = to_float32_toward_zero(v)
    assert got.tolist() == [1.0, -1.0, 1.0 - 2.0 ** -24, 3.0]


def test_tile_order_covers_every_voxel_once():
    B, Z, Y, X = SHAPE
    ids = torch.arange(B * Z * Y * X, dtype=torch.float32).reshape(B, Z, Y, X, 1)
    order = tile_steps(ids).flatten()
    assert torch.equal(order.sort().values, ids.flatten())
    # a k8 step is 8 consecutive voxels of one row
    assert bool((tile_steps(ids)[..., 0].diff(dim=-1) == 1).all())


@pytest.mark.parametrize("cin,cout", [(8, 8), (20, 14)])
def test_three_tf32_passes_over_a_long_reduction_reproduce_the_float64_dw(cin, cout):
    """(a) The 3xTF32 split by truncation, passes summed in float64 over 32,768
    voxels: within 1e-5 of max|dW|."""
    x, dy = data(cin, cout)
    ref = dw64(x, dy)
    (xh, xl), (dh, dl) = split(x), split(dy)
    got = dw64(xl, dh) + dw64(xh, dl) + dw64(xh, dh)  # lo*lo dropped
    err = rel_err(got, ref)
    assert err <= 1e-5, err


@pytest.mark.parametrize("shares", [1, 4])
def test_the_kernels_order_of_sums_holds_the_float32_tolerance(shares):
    """(b) Per-tile temporaries from 0 (each mma rounded toward zero), a float32
    add into the accumulators, S slices added in order: within 1e-4 of max|dW|
    (chip_smoke.py's tolerance), and within 1e-5."""
    x, dy = data(8, 8, seed=1)
    ref = dw64(x, dy)
    err = rel_err(kernel_order_dw(x, dy, shares), ref)
    assert err <= 1e-5, err


def test_one_accumulator_across_a_share_loses_more_than_tile_temporaries():
    """Why the temporaries: with one accumulator across the whole reduction the
    truncations of 12,288 mma sums build up."""
    x, dy = data(8, 8, seed=2)
    ref = dw64(x, dy)
    tiles = rel_err(kernel_order_dw(x, dy, 1), ref)
    single = rel_err(kernel_order_dw(x, dy, 1, tile_temporaries=False), ref)
    assert single > 2 * tiles, (single, tiles)


@pytest.mark.parametrize("mode", ["rna", "truncate"])
def test_one_tf32_pass_is_outside_the_float32_tolerance(mode):
    """(c) One pass of TF32 operands is off by more than 1e-4 of max|dW|: this
    is why float32 storage takes three."""
    x, dy = data(8, 8, seed=3)
    ref = dw64(x, dy)
    err = rel_err(dw64(tf32(x, mode), tf32(dy, mode)), ref)
    assert err > 1e-4, err

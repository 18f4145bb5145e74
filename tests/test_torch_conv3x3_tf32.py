"""The numeric design of the forward conv kernel (spsg_tpu_torch/ops/csrc/conv3x3.cu),
emulated on the CPU: float32 storage is computed on TF32 tensor cores as three
passes (lo*hi + hi*lo + hi*hi of a split v = hi + lo), bfloat16 storage as one.

TF32 keeps 10 explicit significand bits. Two ways of taking them are emulated:
``rna`` is cvt.rna.tf32.f32 (round to nearest, ties away from zero), ``truncate``
is what the kernel does (hi = v with the low 13 bits cleared, so v - hi is
exact; lo = v - hi cleared the same way). Products of two TF32 values are exact
in float64, so the passes are summed in float64 here: what is measured is the
error of the split, the part of the design that decides whether three passes
are needed."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

LOW13 = -(1 << 13)  # int32 mask that clears the 13 low bits (0xffffe000)


def tf32(v: torch.Tensor, mode: str) -> torch.Tensor:
    """float32 -> the TF32 value as float32, by ``mode`` (finite inputs)."""
    bits = v.contiguous().view(torch.int32)
    if mode == "rna":
        # adding half an ulp to the magnitude bits rounds half away from zero
        bits = bits + (1 << 12)
    return (bits & LOW13).view(torch.float32)


def split(v: torch.Tensor, mode: str):
    hi = tf32(v, mode)
    return hi, tf32(v - hi, mode)


def conv64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 zero-pad-1 conv of channel-last x (B,Z,Y,X,Cin), w (3,3,3,Cin,Cout)
    in float64: 27 shifted products, as the kernel's taps."""
    _, Z, Y, X, _ = x.shape
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1, 1, 1))
    out = 0.0
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                out = out + xp[:, dz:dz + Z, dy:dy + Y, dx:dx + X] @ w[dz, dy, dx].double()
    return out


def data(cin, cout=16, seed=0):
    """Unit-variance input, weights of variance 1 / (27 Cin): outputs of unit
    variance, as chip_smoke.py's comparisons have them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 4, 6, 6, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def test_tf32_emulation_keeps_ten_bits():
    v = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11)])
    assert tf32(v, "rna").tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                       1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    assert tf32(v, "truncate").tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0, -1.0]


@pytest.mark.parametrize("mode", ["rna", "truncate"])
@pytest.mark.parametrize("cin", [20, 100])
def test_three_tf32_passes_reproduce_the_float64_conv(mode, cin):
    x, w = data(cin)
    ref = conv64(x, w)
    assert 0.8 < ref.std().item() < 1.2
    xh, xl = split(x, mode)
    wh, wl = split(w, mode)
    # v = hi + lo exactly where hi is truncated; within 2^-22 relative with rna
    assert (xh.double() + xl.double() - x.double()).abs().max().item() <= 2.0 ** -20 * x.abs().max().item()
    got = conv64(xl, wh) + conv64(xh, wl) + conv64(xh, wh)  # lo*lo dropped
    err = (got - ref).abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.parametrize("cin", [20, 100])
def test_one_tf32_pass_is_outside_the_float32_tolerance(cin):
    """One pass (hi*hi of cvt.rna-rounded operands) is ~2^-11 relative per
    product: off by more than chip_smoke.py's 1e-4 on unit-variance outputs.
    This is why float32 takes three passes."""
    x, w = data(cin, seed=1)
    ref = conv64(x, w)
    err = (conv64(tf32(x, "rna"), tf32(w, "rna")) - ref).abs().max().item()
    assert err > 1e-4, err


@pytest.mark.parametrize("mode", ["rna", "truncate"])
def test_bfloat16_values_are_fixed_points_of_the_tf32_rounding(mode):
    """Every finite bfloat16 (8 significand bits) is a TF32 value: hi = v,
    lo = 0, so one pass with exact products serves bfloat16 storage."""
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.bfloat16).float()
    v = v[torch.isfinite(v)]
    assert v.numel() == 65536 - 2 * 128  # all but the infinities and NaNs (exponent all ones)
    hi, lo = split(v, mode)
    assert torch.equal(hi, v)
    assert bool((lo == 0).all())

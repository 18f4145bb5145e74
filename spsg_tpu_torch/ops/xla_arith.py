"""Float32 arithmetic as XLA compiles it for the JAX package on the CPU, in
plain tensor ops that give the same bits on the CPU and on a card.

XLA's CPU backend asks LLVM to fuse every float multiply whose only use is an
add or a subtract into one fused multiply-add (its target options allow FP
fusion everywhere), rewrites a division by a constant as a product with the
constant's float32 reciprocal, evaluates ``exp`` with its own polynomial, and
splits long reductions into blocks. The port's plain versions of the ray
set-up, the march and the depth chain follow those forms site by site, so that
their outputs are the JAX package's to the bit (ROADMAP.md, Queue C, "agreed
arithmetic"); the CUDA kernels use ``__fmaf_rn`` at the same sites. Nothing
here depends on the device's own float32 FMA or on an order that a library
reduction picks: a product of two float32 numbers is exact in float64, and
the sum is rounded to odd in float64 before its one rounding to float32."""

from __future__ import annotations

import torch

_INF = float("inf")
# the smallest normal float32
_TINY = 2.0 ** -126


def _f64(v):
    """A float32 tensor as float64; a Python float as the float32 it rounds to."""
    if isinstance(v, torch.Tensor):
        return v.double()
    return float(torch.tensor(v, dtype=torch.float32))


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add does
    (broadcasting like ``a * b + c``; ``b`` and ``c`` may be Python floats,
    taken as float32). The float64 product of two float32 numbers is exact;
    the float64 sum is corrected to round to odd (its TwoSum error picks the
    neighbour with an odd last bit when the sum was inexact and even), and a
    value rounded to odd in 53 bits rounds to 24 bits as the exact value
    does."""
    a64, b64, c64 = (_f64(v) for v in (a, b, c))
    p = a64 * b64
    s = p + c64
    # TwoSum: the exact sum is s + e
    pv = s - c64
    e = (c64 - (s - pv)) + (p - pv)
    bits = s.view(torch.int64)
    fix = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    s = torch.where(fix, torch.nextafter(s, torch.where(e > 0, _INF, -_INF)), s)
    return s.float()


def recip_const(s: float) -> float:
    """The float32 reciprocal of the float32 ``s`` (both rounded once), as a
    Python float: what XLA multiplies by for a division by the constant."""
    return float(torch.tensor(1.0) / torch.tensor(s, dtype=torch.float32))


def div_const(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` for a constant ``s`` as XLA compiles it: the product with
    :func:`recip_const` of ``s``."""
    return x * recip_const(s)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (XLA's ``sqrt``; PyTorch's
    float32 kernel on a CPU with AVX-512 is off by an ulp on a share of its
    inputs): the float64 root rounded once more, which cannot land on a
    float32 halfway point."""
    return torch.sqrt(x.double()).float()


# XLA's CPU exp for float32 (Cephes' expf): clamp, n = floor(x log2(e) + 1/2),
# the remainder by a two-part ln 2, a degree-5 polynomial, times 2^n built in
# the exponent bits; each constant is a float32
_EXP_LO = -87.80000305175781
_EXP_HI = 88.80000305175781
_LOG2E = 1.4426950216293335
_LN2_HI = 0.693359375
_LN2_LO = -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)


def exp32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor as XLA's CPU backend computes it, with the
    fused multiply-adds that LLVM forms in it, and a result below the
    smallest normal float32 flushed to 0 as XLA's CPU runtime flushes
    denormals (NaN is not handled: the depth chain never takes the exp of
    one)."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(fma32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma32(n, -_LN2_HI, x)
    r = fma32(n, -_LN2_LO, r)
    y = fma32(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = fma32(y, r, p)
    y = fma32(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    return torch.where(out < _TINY, 0.0, out)


def block_sum(terms, block: int = 32) -> torch.Tensor:
    """The sum of ``terms`` (a list of equal-shape float32 tensors) in the
    order of XLA's CPU reduction of that many elements along a minor axis: the
    axis padded to whole blocks of ``block`` (the padding split as evenly as
    it goes, the smaller half in front), each block summed left to right, then
    the blocks' sums left to right (XLA starts each sum from 0: the same but
    for the sign of a zero). Every add is a float32 tensor add, so the bits do
    not depend on the device."""
    n = len(terms)
    nb = -(-n // block)
    front = (nb * block - n) // 2
    total = None
    for i in range(nb):
        lo, hi = max(0, i * block - front), min(n, (i + 1) * block - front)
        part = terms[lo]
        for t in terms[lo + 1:hi]:
            part = part + t
        total = part if total is None else total + part
    return total

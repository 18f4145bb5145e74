"""3x3x3 stride-1 pad-1 channel-last convolutions of the generator, forward and
backward: hand-written CUDA kernels (``csrc/conv3x3.cu``, ``csrc/conv3x3_dw.cu``)
with their plain PyTorch versions beside them.

Replaces the TPU kernels of ``spsg_tpu/ops/pallas_conv.py``:

  * :func:`conv3x3`            <- ``conv3x3`` / ``_fwd_kernel``
  * :func:`conv3x3_act_stats`  <- ``conv3x3_act_stats`` / ``_fwd_act_stats_kernel``
  * :func:`conv3x3_dw`         <- ``_conv3x3_dw_impl`` / ``_dw_kernel``

Layouts are the JAX package's: ``x (B,Z,Y,X,Cin)``, ``w (3,3,3,Cin,Cout)``,
float32 or bfloat16 (``x`` and ``w`` alike), float32 accumulation, output in
the input type; the weight gradient is float32.

Bound on an H100: operations (2*27*Cin*Cout flops per voxel against
(Cin+Cout) stored elements). The forward kernel is an implicit GEMM on the
tensor cores (mma.sync TF32; float32 as 3xTF32, three passes, bfloat16 in
one): a block owns a tile of voxels x all output channels, stages one halo
plane and its taps' weights per 8 input channels with asynchronous copies
(double-buffered), writes the halo's zeros itself (no padded copy of the
input) and reduces the statistics without atomics; the weight-gradient kernel
is a split-K GEMM on the same tensor cores (3xTF32 / one pass alike) whose
per-block partial sums are added by a second kernel in a fixed order. Results
repeat bit for bit. Details in the sources; measured times in PERF.md.

:func:`conv3x3` and :func:`conv3x3_act_stats` are ``torch.autograd.Function``s
with the backward of the JAX package's custom VJPs: ``dx`` is the forward
kernel on the cotangent with flipped, in/out-swapped weights, ``dW`` is
:func:`conv3x3_dw`. Forward and backward are one code path for every device;
inside, dispatch is by where the tensor lives and by nothing else: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build

TAPS = [(dz, dy, dx) for dz in range(3) for dy in range(3) for dx in range(3)]

# launches of each kernel by its wrapper (and by nothing else)
launch_counts = {"conv3x3": 0, "conv3x3_act_stats": 0, "conv3x3_dw": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_libs = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _bind_conv(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/conv3x3.cu`` on ``lib``."""
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.spsg_conv3x3_partial_rows.restype = ctypes.c_longlong
    lib.spsg_conv3x3_partial_rows.argtypes = [i, i, i, i, i]
    lib.spsg_conv3x3_launch.restype = ctypes.c_int
    lib.spsg_conv3x3_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    return lib


def _library():
    lib = _libs.get("conv3x3")
    if lib is None:
        lib = _libs["conv3x3"] = _bind_conv(_build.load("conv3x3"))
    return lib


def _bind_dw(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/conv3x3_dw.cu`` on ``lib``."""
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.spsg_conv3x3_dw_slices.restype = ctypes.c_int
    lib.spsg_conv3x3_dw_slices.argtypes = [i, i, i, i, i, i, i]
    lib.spsg_conv3x3_dw_launch.restype = ctypes.c_int
    lib.spsg_conv3x3_dw_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    # the library convs' weight gradient (ops/libconv_dw.py); an older version
    # of the source, built to be timed beside this one, may have K2 alone
    if hasattr(lib, "spsg_libconv_dw_launch"):
        lib.spsg_libconv_dw_slices.restype = ctypes.c_int
        lib.spsg_libconv_dw_slices.argtypes = [p, p, i, i, i, i, i, i, i, i, i]
        lib.spsg_libconv_dw_launch.restype = ctypes.c_int
        lib.spsg_libconv_dw_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    return lib


def _dw_library():
    lib = _libs.get("conv3x3_dw")
    if lib is None:
        lib = _libs["conv3x3_dw"] = _bind_dw(_build.load("conv3x3_dw"))
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, b=None) -> None:
    if x.dim() != 5:
        raise ValueError(f"conv3x3: x must be (B,Z,Y,X,Cin), got {tuple(x.shape)}")
    if w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3) or w.shape[3] != x.shape[4]:
        raise ValueError(
            f"conv3x3: w must be (3,3,3,{x.shape[4]},Cout), got {tuple(w.shape)}"
        )
    if x.numel() == 0 or w.shape[4] == 0:
        raise ValueError("conv3x3: empty input or output")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(
            f"conv3x3: x and w must both be float32 or both bfloat16, got {x.dtype}, {w.dtype}"
        )
    if w.device != x.device:
        raise ValueError(f"conv3x3: x on {x.device}, w on {w.device}")
    if b is not None:
        if tuple(b.shape) != (w.shape[4],) or b.dtype != torch.float32 or b.device != x.device:
            raise ValueError(
                f"conv3x3_act_stats: b must be float32 ({w.shape[4]},) on {x.device}, "
                f"got {b.dtype} {tuple(b.shape)} on {b.device}"
            )


def _check_dw(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.dim() != 5 or dy.dim() != 5 or tuple(dy.shape[:4]) != tuple(x.shape[:4]):
        raise ValueError(
            f"conv3x3_dw: x (B,Z,Y,X,Cin) and dy (B,Z,Y,X,Cout) must share (B,Z,Y,X), "
            f"got {tuple(x.shape)} and {tuple(dy.shape)}"
        )
    if x.numel() == 0 or dy.numel() == 0:
        raise ValueError("conv3x3_dw: empty input")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(
            f"conv3x3_dw: x and dy must both be float32 or both bfloat16, got {x.dtype}, {dy.dtype}"
        )
    if dy.device != x.device:
        raise ValueError(f"conv3x3_dw: x on {x.device}, dy on {dy.device}")


def _launch(x, w, b):
    """Launch the forward CUDA kernel; returns y, or (y, sum, sumsq) with a bias."""
    tensors = (x, w) if b is None else (x, w, b)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3: CUDA inputs must be contiguous")
    lib = _library()
    B, Z, Y, X, Cin = x.shape
    Cout = w.shape[4]
    with torch.cuda.device(x.device):
        y = torch.empty((B, Z, Y, X, Cout), dtype=x.dtype, device=x.device)
        stats = partials = None
        if b is not None:
            rows = lib.spsg_conv3x3_partial_rows(B, Z, Y, X, Cout)
            if rows <= 0:
                raise ValueError(f"conv3x3: shape {tuple(x.shape)} -> {Cout} is out of range")
            partials = torch.empty((rows, 2, Cout), dtype=torch.float32, device=x.device)
            stats = torch.empty((2, Cout), dtype=torch.float32, device=x.device)
        err = lib.spsg_conv3x3_launch(
            x.data_ptr(), w.data_ptr(),
            b.data_ptr() if b is not None else None,
            y.data_ptr(),
            partials.data_ptr() if partials is not None else None,
            stats.data_ptr() if stats is not None else None,
            B, Z, Y, X, Cin, Cout, _DTYPES[x.dtype], int(b is not None),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"conv3x3: CUDA launch failed with error {err} for x {tuple(x.shape)} "
            f"{x.dtype} -> Cout {Cout}"
        )
    if b is None:
        return y
    return y, stats[0], stats[1]


def _launch_dw(x, dy):
    """Launch the weight-gradient CUDA kernels; returns dW (3,3,3,Cin,Cout) float32."""
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("conv3x3_dw: CUDA inputs must be contiguous")
    lib = _dw_library()
    B, Z, Y, X, Cin = x.shape
    Cout = dy.shape[4]
    dtype = _DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        slices = lib.spsg_conv3x3_dw_slices(B, Z, Y, X, Cin, Cout, dtype)
        if slices <= 0:
            raise ValueError(
                f"conv3x3_dw: shape {tuple(x.shape)} x {tuple(dy.shape)} is out of range "
                f"(or the device could not be queried): {slices}"
            )
        dw = torch.empty((3, 3, 3, Cin, Cout), dtype=torch.float32, device=x.device)
        partials = None
        if slices > 1:
            partials = torch.empty((slices, 27, Cin, Cout), dtype=torch.float32, device=x.device)
        err = lib.spsg_conv3x3_dw_launch(
            x.data_ptr(), dy.data_ptr(),
            partials.data_ptr() if partials is not None else None,
            dw.data_ptr(), B, Z, Y, X, Cin, Cout, dtype, slices,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"conv3x3_dw: CUDA launch failed with error {err} for x {tuple(x.shape)} "
            f"{x.dtype}, dy Cout {Cout}"
        )
    return dw


# ---------------------------------------------------------------------------
# the three functions by device (no autograd in here)
# ---------------------------------------------------------------------------


def _device_kind(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def _conv(x, w):
    if _device_kind(x, "conv3x3") == "cpu":
        return conv3x3_plain(x, w)
    y = _launch(x, w, None)
    launch_counts["conv3x3"] += 1
    return y


def _conv_act_stats(x, w, b):
    if _device_kind(x, "conv3x3_act_stats") == "cpu":
        return conv3x3_act_stats_plain(x, w, b)
    if x.dtype != torch.float32:
        b = b.to(x.dtype).float()
    out = _launch(x, w, b)
    launch_counts["conv3x3_act_stats"] += 1
    return out


def conv3x3_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of :func:`conv3x3`: ``dW[dz,dy,dx,ci,co]`` = sum over
    (b,z,y,x) of ``xpad[b,z+dz,y+dy,x+dx,ci] * dy[b,z,y,x,co]``, float32
    ``(3,3,3,Cin,Cout)`` whatever the storage type of ``x`` and ``dy``. CUDA
    tensors go to the kernel, CPU tensors to :func:`conv3x3_dw_plain`."""
    _check_dw(x, dy)
    if _device_kind(x, "conv3x3_dw") == "cpu":
        return conv3x3_dw_plain(x, dy)
    dw = _launch_dw(x, dy)
    launch_counts["conv3x3_dw"] += 1
    return dw


def _input_grads(ctx, x, w, dconv):
    """(dx, dW) of ``conv(x, w)`` for the cotangent ``dconv`` of its output, in
    the types of ``x`` and ``w``; None where ``ctx`` needs no gradient."""
    dx = dw = None
    if ctx.needs_input_grad[0]:
        w_flip = torch.flip(w, (0, 1, 2)).transpose(3, 4).contiguous()
        dx = _conv(dconv, w_flip.to(dconv.dtype)).to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = conv3x3_dw(x, dconv).to(w.dtype)
    return dx, dw


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        # autograd hands over slices of a cat, expands of an upsample, ...
        return _input_grads(ctx, x, w, dy.contiguous())


class _Conv3x3ActStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y, s, ss = _conv_act_stats(x, w, b)
        # the stored activation, not the pre-activation: LeakyReLU's slope
        # 0.2 > 0 keeps the sign, so the slope is read from the sign of y
        ctx.save_for_backward(x, w, y)
        ctx.set_materialize_grads(False)
        return y, s, ss

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, ds, dss):
        x, w, y = ctx.saved_tensors
        # cotangents through the statistics: s = sum(y), ss = sum(y^2); an
        # absent cotangent (eval-mode BatchNorm ignores the sums) is zero
        dy_total = torch.zeros(y.shape, dtype=torch.float32, device=y.device) \
            if dy is None else dy.float()
        if ds is not None:
            dy_total = dy_total + ds
        if dss is not None:
            dy_total = dy_total + 2.0 * y.float() * dss
        # rounded to the stored type before db is summed and before the
        # kernels read it, as the JAX package does
        dconv = torch.where(y > 0, dy_total, 0.2 * dy_total).to(y.dtype).contiguous()
        del dy_total
        db = dconv.float().sum(dim=(0, 1, 2, 3)) if ctx.needs_input_grad[2] else None
        dx, dw = _input_grads(ctx, x, w, dconv)
        return dx, dw, db


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 stride-1 zero-pad-1 convolution, no bias, differentiable in ``x``
    and ``w``. CUDA tensors go to the kernels (forward and backward), CPU
    tensors to the plain versions."""
    _check(x, w)
    _device_kind(x, "conv3x3")
    return _Conv3x3.apply(x, w)


def conv3x3_act_stats(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused conv + bias + LeakyReLU(0.2) + BatchNorm batch statistics.

    Returns ``(y, sum, sumsq)``: ``y`` in the input type, and the float32
    per-channel sum and sum of squares of the stored ``y`` over all
    (B,Z,Y,X) positions. ``b`` is float32 ``(Cout,)``; like the JAX package
    it is rounded to the input type before it is added. All three outputs are
    differentiable in ``x``, ``w`` and ``b``."""
    _check(x, w, b)
    _device_kind(x, "conv3x3_act_stats")
    return _Conv3x3ActStats.apply(x, w, b)


# ---------------------------------------------------------------------------
# plain versions: the same arithmetic, step by step
# ---------------------------------------------------------------------------


def _conv3x3_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 accumulator of the conv: 27 shifted views of the zero-padded
    input, each ``@ w[dz,dy,dx]``, summed in tap order."""
    _, Z, Y, X, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dz, dy, dx in TAPS:
        v = xp[:, dz:dz + Z, dy:dy + Y, dx:dx + X, :] @ wf[dz, dy, dx]
        acc = v if acc is None else acc + v
    return acc


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3x3` (any device)."""
    _check(x, w)
    return _conv3x3_f32(x, w).to(x.dtype)


def conv3x3_act_stats_plain(x, w, b):
    """Plain PyTorch version of :func:`conv3x3_act_stats` (any device)."""
    _check(x, w, b)
    out = _conv3x3_f32(x, w) + b.to(x.dtype).float()
    out = torch.where(out > 0, out, 0.2 * out)
    y = out.to(x.dtype)
    yf = y.float()
    return y, yf.sum(dim=(0, 1, 2, 3)), (yf * yf).sum(dim=(0, 1, 2, 3))


def conv3x3_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3x3_dw` (any device): 27 shifted
    views of the zero-padded input, each contracted with ``dy`` over
    (b,z,y,x) in float32, stacked in tap order."""
    _check_dw(x, dy)
    _, Z, Y, X, Cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    g = dy.float().reshape(-1, dy.shape[4])
    taps = [
        xp[:, dz:dz + Z, dy_:dy_ + Y, dx:dx + X, :].reshape(-1, Cin).t() @ g
        for dz, dy_, dx in TAPS
    ]
    return torch.stack(taps).reshape(3, 3, 3, Cin, dy.shape[4])

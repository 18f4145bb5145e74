"""The generator's library convs (the cubic convs that are not 3x3x3 / stride
1: the 5^3 entry convs and the 4^3 stride-2 downsamplers) with a hand-written
weight gradient: forward and input gradient are cuDNN's (``F.conv3d`` and its
dgrad), the weight gradient a CUDA kernel (``csrc/conv3x3_dw.cu``,
``libconv_dw_kernel`` + ``libconv_dw_join_kernel``) with its plain PyTorch
version beside it.

No TPU kernel stands behind it: the JAX package leaves these convs to XLA.
cuDNN computes their float32 weight gradient with a direct kernel (no tensor
cores at Cin 1 and 4), the largest single cost of the training step on an H100
(PERF.md). The kernel is a split-K GEMM on the tensor cores, float32 as 3xTF32,
whose per-block partial sums are added by a second kernel in a fixed order:
results repeat bit for bit. Details in the source; measured times in PERF.md.

Layouts: ``x (B,Z,Y,X,Cin)`` and ``dy (B,OZ,OY,OX,Cout)`` channel-last,
weights in PyTorch's ``(Cout, Cin, K, K, K)``; float32 only. Dispatch is by
where the tensor lives and by nothing else: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import conv3x3 as conv_ops

# launches of the weight-gradient kernel by its wrapper (and by nothing else)
launch_counts = {"libconv_dw": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(x: torch.Tensor, dy: torch.Tensor, kernel: int, stride: int, padding: int) -> None:
    if x.dim() != 5 or dy.dim() != 5 or x.shape[0] != dy.shape[0]:
        raise ValueError(
            f"libconv_dw: x (B,Z,Y,X,Cin) and dy (B,OZ,OY,OX,Cout) must share B, "
            f"got {tuple(x.shape)} and {tuple(dy.shape)}")
    out = tuple((n + 2 * padding - kernel) // stride + 1 for n in x.shape[1:4])
    if tuple(dy.shape[1:4]) != out:
        raise ValueError(
            f"libconv_dw: a {kernel}^3 stride-{stride} pad-{padding} conv of x "
            f"{tuple(x.shape)} gives (OZ,OY,OX) {out}, dy is {tuple(dy.shape)}")
    if x.numel() == 0 or dy.numel() == 0:
        raise ValueError("libconv_dw: empty input")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"libconv_dw: x and dy must be float32, got {x.dtype}, {dy.dtype}")
    if dy.device != x.device:
        raise ValueError(f"libconv_dw: x on {x.device}, dy on {dy.device}")


def _launch(x, dy, kernel, stride, padding):
    """Launch the weight-gradient CUDA kernels; returns dW (Cout,Cin,K,K,K) float32."""
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("libconv_dw: CUDA inputs must be contiguous")
    lib = conv_ops._dw_library()
    B, Z, Y, X, Cin = x.shape
    Cout = dy.shape[4]
    geom = (B, Z, Y, X, Cin, Cout, kernel, stride, padding)
    with torch.cuda.device(x.device):
        slices = lib.spsg_libconv_dw_slices(x.data_ptr(), dy.data_ptr(), *geom)
        if slices <= 0:
            raise ValueError(
                f"libconv_dw: a {kernel}^3 stride-{stride} pad-{padding} conv of x "
                f"{tuple(x.shape)} -> Cout {Cout} is out of range (or the device could "
                f"not be queried): {slices}")
        dw = torch.empty((Cout, Cin, kernel, kernel, kernel), dtype=torch.float32,
                         device=x.device)
        partials = torch.empty((slices, kernel ** 3, Cin, Cout), dtype=torch.float32,
                               device=x.device)
        err = lib.spsg_libconv_dw_launch(
            x.data_ptr(), dy.data_ptr(), partials.data_ptr(), dw.data_ptr(), *geom, slices,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"libconv_dw: CUDA launch failed with error {err} for x {tuple(x.shape)}, "
            f"dy {tuple(dy.shape)}, kernel {kernel}, stride {stride}, padding {padding}")
    return dw


def libconv_dw(x: torch.Tensor, dy: torch.Tensor, kernel: int, stride: int,
               padding: int) -> torch.Tensor:
    """Weight gradient of a ``kernel``^3, ``stride``, ``padding`` conv of the
    channel-last ``x`` whose output's cotangent is the channel-last ``dy``:
    ``dW[co,ci,kz,ky,kx]`` = sum over (b,z,y,x) of
    ``xpad[b, S*z+kz, S*y+ky, S*x+kx, ci] * dy[b,z,y,x,co]``, float32
    ``(Cout,Cin,K,K,K)``. CUDA tensors go to the kernel, CPU tensors to
    :func:`libconv_dw_plain`."""
    _check(x, dy, kernel, stride, padding)
    if x.device.type == "cpu":
        return libconv_dw_plain(x, dy, kernel, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"libconv_dw: unsupported device {x.device}")
    dw = _launch(x, dy, kernel, stride, padding)
    launch_counts["libconv_dw"] += 1
    return dw


def libconv_dw_plain(x: torch.Tensor, dy: torch.Tensor, kernel: int, stride: int,
                     padding: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`libconv_dw` (any device): the library's
    weight gradient on the ``(B,C,Z,Y,X)`` views."""
    _check(x, dy, kernel, stride, padding)
    return torch.nn.grad.conv3d_weight(
        x.permute(0, 4, 1, 2, 3), (dy.shape[4], x.shape[4], kernel, kernel, kernel),
        dy.permute(0, 4, 1, 2, 3), stride, padding)


class _LibraryConv(torch.autograd.Function):
    """``F.conv3d`` on channel-last tensors without a bias: forward and dx are
    the library's, dW is :func:`libconv_dw`."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, stride, padding)
        return y.permute(0, 2, 3, 4, 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        s, p = ctx.stride, ctx.padding
        # autograd may hand over a strided view
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                dy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), w, None, (s,) * 3,
                (p,) * 3, (1, 1, 1), False, (0, 0, 0), 1, (True, False, False))[0]
            dx = dx.permute(0, 2, 3, 4, 1)
        if ctx.needs_input_grad[1]:
            dw = libconv_dw(x.contiguous(), dy, w.shape[2], s, p)
        return dx, dw, None, None


def library_conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """A cubic conv of the channel-last float32 ``x`` (B,Z,Y,X,Cin) with ``w``
    (Cout,Cin,K,K,K), no bias, dilation 1, the same ``stride`` and ``padding``
    on the three axes; the output channel-last
    (B,OZ,OY,OX,Cout). Differentiable in ``x`` and ``w``: dx by the library,
    dW by :func:`libconv_dw`."""
    if w.dim() != 5 or len({w.shape[2], w.shape[3], w.shape[4]}) != 1:
        raise ValueError(f"library_conv: w must be (Cout,Cin,K,K,K), got {tuple(w.shape)}")
    return _LibraryConv.apply(x, w, stride, padding)


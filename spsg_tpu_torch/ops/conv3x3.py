"""3x3x3 stride-1 pad-1 channel-last convolutions of the generator: hand-written
CUDA kernels (``csrc/conv3x3.cu``) with their plain PyTorch versions beside them.

Replaces the TPU kernels of ``spsg_tpu/ops/pallas_conv.py``:

  * :func:`conv3x3`            <- ``conv3x3`` / ``_fwd_kernel``
  * :func:`conv3x3_act_stats`  <- ``conv3x3_act_stats`` / ``_fwd_act_stats_kernel``

Layouts are the JAX package's: ``x (B,Z,Y,X,Cin)``, ``w (3,3,3,Cin,Cout)``,
float32 or bfloat16 (``x`` and ``w`` alike), float32 accumulation, output in
the input type.

Bound on an H100: operations (2*27*Cin*Cout flops per voxel against
(Cin+Cout) stored elements). The kernel tiles voxels x output channels in
registers, stages a halo slab and one Cin-chunk of the weights in shared
memory, zero-fills the halo itself (no padded copy of the input) and reduces
the statistics without atomics, so results repeat bit for bit. Details in the
source; measured times in PERF.md.

Dispatch is by where the tensor lives and by nothing else: a CUDA tensor
launches the kernel or raises, a CPU tensor takes the plain version. The
backward pass of the kernels is not written yet (ROADMAP.md), so on CUDA an
input that requires grad raises ``NotImplementedError``; the plain versions
are ordinary differentiable PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

TAPS = [(dz, dy, dx) for dz in range(3) for dy in range(3) for dx in range(3)]

# launches of each kernel by its wrapper (and by nothing else)
launch_counts = {"conv3x3": 0, "conv3x3_act_stats": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("conv3x3")
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.spsg_conv3x3_partial_rows.restype = ctypes.c_longlong
        lib.spsg_conv3x3_partial_rows.argtypes = [i, i, i, i, i]
        lib.spsg_conv3x3_launch.restype = ctypes.c_int
        lib.spsg_conv3x3_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        _lib = lib
    return _lib


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


def _launch(x, w, b):
    """Launch the CUDA kernel; returns y, or (y, sum, sumsq) with a bias."""
    tensors = (x, w) if b is None else (x, w, b)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3: CUDA inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "conv3x3: the CUDA kernels have no backward yet (ROADMAP.md, training "
            "slice); call under torch.no_grad() or use CPU tensors"
        )
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


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 stride-1 zero-pad-1 convolution, no bias. CUDA tensors go to the
    kernel, CPU tensors to :func:`conv3x3_plain`."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    y = _launch(x, w, None)
    launch_counts["conv3x3"] += 1
    return y


def conv3x3_act_stats(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused conv + bias + LeakyReLU(0.2) + BatchNorm batch statistics.

    Returns ``(y, sum, sumsq)``: ``y`` in the input type, and the float32
    per-channel sum and sum of squares of the stored ``y`` over all
    (B,Z,Y,X) positions. ``b`` is float32 ``(Cout,)``; like the JAX package
    it is rounded to the input type before it is added."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_act_stats_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_act_stats: unsupported device {x.device}")
    if x.dtype != torch.float32:
        b = b.to(x.dtype).float()
    out = _launch(x, w, b)
    launch_counts["conv3x3_act_stats"] += 1
    return out


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

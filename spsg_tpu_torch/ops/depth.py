"""Depth-image preprocessing (PyTorch counterpart of ``spsg_tpu/ops/depth.py``;
reference CUDA extension torch/utils/depth_utils/depth_utils_cuda_kernel.cu).

Each stage has a hand kernel for the card (``csrc/depth.cu``) and its plain
PyTorch version beside it (``*_plain``): the bilateral filter (K9,
:func:`bilateral_filter`), one round of the median hole fill (K10,
:func:`median_fill`), the fill loop around them (:func:`fill_depth_holes`) and
the unprojection with the cross-product normals (K11,
:func:`unproject_normals`). Dispatch is by where the tensors live and by
nothing else: a CUDA tensor launches the kernel or raises, a CPU tensor takes
the plain version. None replaces a Pallas kernel: the JAX package left the
chain to XLA.

The plain versions are pixel-parallel stencils written as shifted-window
reductions, in the arithmetic that XLA compiles the JAX package's versions to
on the CPU (:mod:`.xla_arith`: its ``exp``, its order of the window sums, its
fused multiply-adds, correctly rounded roots), so that the filled depth is the
JAX package's to the bit on either device; the kernels compute the same bits.
The plain fill keeps the reference's early exit (depth_utils.py:84-94): each
test of "any hole left" reads a flag back to the host, once before the fill
and once per round, at most ``max_iters + 1`` times a call. The kernel path
reads nothing back: K9 lists the filtered frames' holes on the card, and one
cooperative launch of K10 runs every round over the shrinking hole list, a
warp a hole, until a round leaves no hole or ``max_iters`` rounds after the
first, so the rounds that run are the plain loop's. :data:`host_syncs` counts
the plain loop's reads, the only ones that remain.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .raycast import _check_cuda, _device_kind, _raise_on, _stream
from .xla_arith import block_sum, div_const, exp32, fma32, recip_const, sqrt32

# host reads of the plain fill loop's early-exit flag since the last reset
host_syncs = {"fill_depth_holes": 0}
# launches of each kernel by its wrapper (and by nothing else): K9, K10 (a
# single round, or the one cooperative launch that runs every round of a fill),
# K11
launch_counts = {"depth_bilateral": 0, "depth_median_round": 0, "depth_normals": 0}
_libs = {}
_spatial = {}


def reset_host_syncs() -> None:
    for k in host_syncs:
        host_syncs[k] = 0


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _any(x: torch.Tensor) -> bool:
    host_syncs["fill_depth_holes"] += 1
    return bool(x.any())


def _window_stack(img: torch.Tensor, radius: int, fill: float) -> torch.Tensor:
    """(B, H, W) -> (B, H, W, K*K) stack of the (2r+1)^2 neighbourhood, padded
    with ``fill`` outside the image, in row-major window order."""
    k = 2 * radius + 1
    padded = F.pad(img, (radius, radius, radius, radius), value=fill)
    H, W = img.shape[1], img.shape[2]
    return torch.stack(
        [padded[:, i:i + H, j:j + W] for i in range(k) for j in range(k)], dim=-1)


def _spatial_weights(sigma_d: float, device) -> torch.Tensor:
    """The bilateral filter's (2r+1)^2 spatial weights, r = ceil(2 sigma_d), in
    row-major window order, as XLA computes them: ``exp`` of the squared
    offset times the float32 reciprocal of 2 sigma_d^2."""
    radius = int(math.ceil(2.0 * sigma_d))
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    return exp32(div_const(-(ox * ox + oy * oy), 2.0 * sigma_d ** 2)).reshape(-1)


def bilateral_filter_plain(depth: torch.Tensor, sigma_d: float = 2.0,
                           sigma_r: float = 0.1) -> torch.Tensor:
    """Bilateral depth filter (reference bilateral_filter_floatmap_kernel,
    cu:41-86). depth (B, H, W), 0 = hole. Holes stay 0; valid pixels get the
    range-weighted Gaussian average of their valid neighbours. As XLA computes
    it: both Gaussians through its ``exp`` with the divisions by constants as
    products, each tap's weight ``w_spatial * w_range`` where the neighbour is
    valid, and the weights and the rounded products ``w * neighbour`` summed
    over the window in its blocks of 32 taps (:func:`.xla_arith.block_sum`)."""
    radius = int(math.ceil(2.0 * sigma_d))
    k = 2 * radius + 1
    w_spatial = _spatial_weights(sigma_d, depth.device)
    padded = F.pad(depth, (radius, radius, radius, radius), value=0.0)
    H, W = depth.shape[1], depth.shape[2]
    # taps first: (k*k, B, H, W) in row-major window order
    win = torch.stack([padded[:, i:i + H, j:j + W] for i in range(k) for j in range(k)])
    d = win - depth
    w_range = exp32(div_const(d * -d, 2.0 * sigma_r ** 2))
    w = torch.where(win != 0.0, w_spatial[:, None, None, None] * w_range, 0.0)
    wsum = block_sum(list(w))
    num = block_sum(list(w * win))
    out = torch.where(wsum > 0.0, num / torch.clamp(wsum, min=1e-12), 0.0)
    return torch.where(depth != 0.0, out, 0.0)


def median_fill_plain(depth: torch.Tensor, structure_radius: int = 5) -> torch.Tensor:
    """One hole-filling pass: invalid (0) pixels get the reference's
    quasi-median of the valid neighbours in an 11x11 window, in integer
    millimetres (median_fill_depthmap_kernel, cu:89-140): sorted ascending,
    the element ``min((n+1)//2, n-1)`` of the n valid ones (the upper median)."""
    win = _window_stack(depth, structure_radius, 0.0)
    # millimetres, 1000 * depth + 0.5 as one fused multiply-add as XLA forms
    # it: a function of each pixel, so taken once a pixel and then stacked
    mm = torch.where(depth != 0.0, torch.floor(fma32(depth, 1000.0, 0.5)), torch.inf)
    s = torch.sort(_window_stack(mm, structure_radius, torch.inf), dim=-1).values
    num_valid = (win != 0.0).sum(dim=-1)
    pick = torch.minimum((num_valid + 1) // 2, torch.clamp(num_valid - 1, min=0))
    val = torch.gather(s, -1, pick[..., None])[..., 0]
    filled = torch.where(torch.isfinite(val) & (num_valid > 0), 0.001 * val, 0.0)
    return torch.where(depth != 0.0, depth, filled)


def fill_depth_holes_plain(depth: torch.Tensor, max_iters: int = 40):
    """Iterated median fill seeded from the bilateral-filtered map, stopping
    early when no holes remain (reference Depth2Normals.forward,
    depth_utils.py:84-94). Returns (filled (B, H, W), all_valid (B,) bool).

    Each frame decides for itself: a frame without holes passes through
    untouched whatever its batch-mates hold, and the loop runs while a frame
    that had holes still has one. A frame's result then does not depend on the
    other frames of the batch (a median pass leaves a filled frame as it is),
    so a frame's cached views equal the ones it would get in any other batch
    (``training/loop.py::RenderCache``). The JAX package decides for the whole
    batch: there, a frame without holes is filtered when a batch-mate has one
    (ROADMAP.md, Queue C)."""
    had = (depth == 0.0).reshape(depth.shape[0], -1).any(dim=-1)  # (B,): frames with holes
    if not _any(had):
        return depth, torch.ones_like(had)
    had = had[:, None, None]
    out = median_fill_plain(bilateral_filter_plain(depth))
    it = 0
    while it < max_iters and _any((out == 0.0) & had):
        out = median_fill_plain(out)
        it += 1
    out = torch.where(had, out, depth)
    all_valid = ~(out.reshape(out.shape[0], -1) == 0.0).any(dim=-1)
    return out, all_valid


def depth_to_camera_space(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject (B, H, W) depth to camera-space points (B, H, W, 3)
    (reference convert_depth_to_cameraspace_kernel, cu:142-170).
    intrinsics (B, 4) = [fx, fy, mx, my]."""
    _, H, W = depth.shape
    xs = torch.arange(W, dtype=torch.float32, device=depth.device)
    ys = torch.arange(H, dtype=torch.float32, device=depth.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    fx, fy, mx, my = (intrinsics[:, i][:, None, None] for i in range(4))
    px = depth * (gx[None] - mx) / fx
    py = depth * (gy[None] - my) / fy
    pts = torch.stack([px, py, depth], dim=-1)
    return torch.where(depth[..., None] != 0.0, pts, 0.0)


def camera_space_normals(pts: torch.Tensor) -> torch.Tensor:
    """Cross-product normals from camera-space neighbours (reference
    compute_normals_kernel, cu:172-211). pts (B, H, W, 3) -> (B, H, W, 3),
    zero where undefined and on the border."""
    pc = torch.roll(pts, -1, dims=1)  # y+1
    mc = torch.roll(pts, 1, dims=1)  # y-1
    cp = torch.roll(pts, -1, dims=2)  # x+1
    cm = torch.roll(pts, 1, dims=2)  # x-1
    a, b = pc - mc, cp - cm
    # as XLA fuses the cross product: the first product of each difference
    # fused with the subtraction of the rounded second; the squared norm
    # summed by fused multiply-adds, its root correctly rounded
    n = torch.stack([fma32(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
                     fma32(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
                     fma32(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0]))], dim=-1)
    l2 = fma32(n[..., 2], n[..., 2], fma32(n[..., 1], n[..., 1], n[..., 0] * n[..., 0]))[..., None]
    ln = sqrt32(torch.clamp(l2, min=1e-24))
    some_valid = ((pts[..., 0] != 0) | (pc[..., 0] != 0) | (cp[..., 0] != 0)
                  | (mc[..., 0] != 0) | (cm[..., 0] != 0))
    out = torch.where((l2 > 0.0) & some_valid[..., None], n / -ln, 0.0)
    _, H, W, _ = pts.shape
    ys = torch.arange(H, device=pts.device)[None, :, None]
    xs = torch.arange(W, device=pts.device)[None, None, :]
    interior = (ys > 0) & (ys < H - 1) & (xs > 0) & (xs < W - 1)
    return torch.where(interior[..., None], out, 0.0)


def unproject_normals_plain(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Normals (B, H, W, 3) of a depth map: :func:`depth_to_camera_space`, then
    :func:`camera_space_normals`."""
    return camera_space_normals(depth_to_camera_space(depth, intrinsics))


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------


def _library():
    lib = _libs.get("depth")
    if lib is None:
        lib = _build.load("depth")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.spsg_depth_bilateral.restype = i
        lib.spsg_depth_bilateral.argtypes = [p] * 3 + [i] * 4 + [f, p]
        lib.spsg_depth_median_round.restype = i
        lib.spsg_depth_median_round.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.spsg_depth_fill.restype = i
        lib.spsg_depth_fill.argtypes = [p] * 8 + [i] * 4 + [f, i, i, p]
        lib.spsg_depth_normals.restype = i
        lib.spsg_depth_normals.argtypes = [p] * 3 + [i] * 3 + [p]
        _libs["depth"] = lib
    return lib


def _frames(depth: torch.Tensor, what: str) -> torch.Tensor:
    if depth.dim() != 3 or depth.dtype != torch.float32:
        raise ValueError(f"{what}: depth must be float32 (B, H, W), got {depth.dtype} "
                         f"{tuple(depth.shape)}")
    return depth.contiguous()


def _bilateral_args(sigma_d: float, sigma_r: float):
    """(spatial weights in host memory, radius, range scale) of K9: the
    kernel takes the weights by value, not from device memory."""
    if sigma_d not in _spatial:
        _spatial[sigma_d] = _spatial_weights(sigma_d, "cpu").contiguous()
    return _spatial[sigma_d], int(math.ceil(2.0 * sigma_d)), recip_const(2.0 * sigma_r ** 2)


def bilateral_filter(depth: torch.Tensor, sigma_d: float = 2.0,
                     sigma_r: float = 0.1) -> torch.Tensor:
    """The bilateral filter of :func:`bilateral_filter_plain`: K9 on a CUDA
    tensor, the plain version on a CPU tensor; the same bits."""
    if _device_kind(depth, "depth_bilateral") == "cpu":
        return bilateral_filter_plain(depth, sigma_d, sigma_r)
    depth = _frames(depth, "depth_bilateral")
    w_spatial, radius, scale = _bilateral_args(sigma_d, sigma_r)
    out = torch.empty_like(depth)
    B, H, W = depth.shape
    with torch.cuda.device(depth.device):
        err = _library().spsg_depth_bilateral(depth.data_ptr(), w_spatial.data_ptr(),
                                              out.data_ptr(), B, H, W, radius, scale,
                                              _stream(depth))
    _raise_on(err, "depth_bilateral", depth.shape)
    launch_counts["depth_bilateral"] += 1
    return out


def median_fill(depth: torch.Tensor, structure_radius: int = 5) -> torch.Tensor:
    """One round of :func:`median_fill_plain`: K10 on a CUDA tensor, the plain
    version on a CPU tensor; the same bits."""
    if _device_kind(depth, "depth_median_round") == "cpu":
        return median_fill_plain(depth, structure_radius)
    depth = _frames(depth, "depth_median_round")
    out = torch.empty_like(depth)
    B, H, W = depth.shape
    # scratch: the round's hole list and its count
    holes = torch.empty(B * H * W + 1, dtype=torch.int32, device=depth.device)
    with torch.cuda.device(depth.device):
        err = _library().spsg_depth_median_round(
            depth.data_ptr(), out.data_ptr(), holes.data_ptr(), holes[-1:].data_ptr(), B, H, W,
            structure_radius, _stream(depth))
    _raise_on(err, "depth_median_round", depth.shape)
    launch_counts["depth_median_round"] += 1
    return out


def fill_depth_holes(depth: torch.Tensor, max_iters: int = 40):
    """:func:`fill_depth_holes_plain` (the same outputs, to the bit). On a
    CUDA tensor: K9 on every frame (listing its holes), then one cooperative
    launch of K10 that runs the plain loop's rounds over the hole list, with
    no read back to the host; a frame without holes comes out as it went
    in."""
    if _device_kind(depth, "fill_depth_holes") == "cpu":
        return fill_depth_holes_plain(depth, max_iters)
    depth = _frames(depth, "fill_depth_holes")
    if max_iters < 0:
        raise ValueError(f"fill_depth_holes: max_iters must be >= 0, got {max_iters}")
    w_spatial, radius, scale = _bilateral_args(2.0, 0.1)
    B, H, W = depth.shape
    buf0, buf1, out = (torch.empty_like(depth) for _ in range(3))
    # the two hole lists; had, the lists' counts and the rounds' flags
    lists = torch.empty(2 * B * H * W, dtype=torch.int32, device=depth.device)
    flags = torch.empty(B + 2 * max_iters + 3, dtype=torch.int32, device=depth.device)
    all_valid = torch.empty(B, dtype=torch.bool, device=depth.device)
    with torch.cuda.device(depth.device):
        err = _library().spsg_depth_fill(
            depth.data_ptr(), w_spatial.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
            lists.data_ptr(), flags.data_ptr(), out.data_ptr(), all_valid.data_ptr(), B, H, W,
            radius, scale, 5, max_iters, _stream(depth))
    _raise_on(err, "fill_depth_holes", depth.shape)
    launch_counts["depth_bilateral"] += 1
    launch_counts["depth_median_round"] += 1
    return out, all_valid


def unproject_normals(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """:func:`unproject_normals_plain`: K11 on CUDA tensors, the plain version
    on CPU tensors; the same bits (the border, where the plain version's roll
    wraps around, is 0 in both)."""
    if _device_kind(depth, "depth_normals") == "cpu":
        return unproject_normals_plain(depth, intrinsics)
    depth = _frames(depth, "depth_normals")
    B, H, W = depth.shape
    if intrinsics.dtype != torch.float32 or tuple(intrinsics.shape) != (B, 4):
        raise ValueError(f"depth_normals: intrinsics must be float32 ({B}, 4), got "
                         f"{intrinsics.dtype} {tuple(intrinsics.shape)}")
    intrinsics = intrinsics.contiguous()
    _check_cuda("depth_normals", depth, intrinsics)
    normals = torch.empty((B, H, W, 3), dtype=torch.float32, device=depth.device)
    with torch.cuda.device(depth.device):
        err = _library().spsg_depth_normals(depth.data_ptr(), intrinsics.data_ptr(),
                                            normals.data_ptr(), B, H, W, _stream(depth))
    _raise_on(err, "depth_normals", depth.shape)
    launch_counts["depth_normals"] += 1
    return normals


def depth_to_normals(depth: torch.Tensor, intrinsics: torch.Tensor, max_fill_iters: int = 40):
    """The Depth2Normals chain (reference depth_utils.py:66-99): bilateral-seeded
    median hole fill -> camera-space unprojection -> cross normals. Returns
    (normals (B, H, W, 3), filled depth (B, H, W), all_valid (B,) bool).
    The fill decides per frame (:func:`fill_depth_holes`)."""
    if max_fill_iters > 0:
        filled, all_valid = fill_depth_holes(depth, max_fill_iters)
    else:
        filled = depth
        all_valid = ~(depth.reshape(depth.shape[0], -1) == 0.0).any(dim=-1)
    return unproject_normals(filled, intrinsics), filled, all_valid

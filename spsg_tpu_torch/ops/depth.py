"""Depth-image preprocessing (PyTorch counterpart of ``spsg_tpu/ops/depth.py``;
reference CUDA extension torch/utils/depth_utils/depth_utils_cuda_kernel.cu).

Pixel-parallel stencils written as shifted-window reductions in plain PyTorch.
The iterated median hole-fill keeps the reference's early exit
(depth_utils.py:84-94): on a CUDA tensor each test of "any hole left" reads a
flag back to the host, once before the fill and once per iteration, at most
``max_iters + 1`` times a call. :data:`host_syncs` counts those reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# host reads of the fill loop's early-exit flag since the last reset
host_syncs = {"fill_depth_holes": 0}


def reset_host_syncs() -> None:
    for k in host_syncs:
        host_syncs[k] = 0


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


def bilateral_filter(depth: torch.Tensor, sigma_d: float = 2.0,
                     sigma_r: float = 0.1) -> torch.Tensor:
    """Bilateral depth filter (reference bilateral_filter_floatmap_kernel,
    cu:41-86). depth (B, H, W), 0 = hole. Holes stay 0; valid pixels get the
    range-weighted Gaussian average of their valid neighbours."""
    radius = int(math.ceil(2.0 * sigma_d))
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=depth.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    w_spatial = torch.exp(-(ox ** 2 + oy ** 2) / (2.0 * sigma_d ** 2)).reshape(-1)

    win = _window_stack(depth, radius, 0.0)
    valid_win = win != 0.0
    center = depth[..., None]
    w_range = torch.exp(-((win - center) ** 2) / (2.0 * sigma_r ** 2))
    w = w_spatial * w_range * valid_win
    wsum = w.sum(dim=-1)
    num = (w * win).sum(dim=-1)
    out = torch.where(wsum > 0.0, num / torch.clamp(wsum, min=1e-12), 0.0)
    return torch.where(depth != 0.0, out, 0.0)


def median_fill(depth: torch.Tensor, structure_radius: int = 5) -> torch.Tensor:
    """One hole-filling pass: invalid (0) pixels get the reference's
    quasi-median of the valid neighbours in an 11x11 window, in integer
    millimetres (median_fill_depthmap_kernel, cu:89-140): sorted ascending,
    the element ``min((n+1)//2, n-1)`` of the n valid ones (the upper median)."""
    win = _window_stack(depth, structure_radius, 0.0)
    q = torch.where(win != 0.0, torch.floor(1000.0 * win + 0.5), torch.inf)
    s = torch.sort(q, dim=-1).values
    num_valid = (win != 0.0).sum(dim=-1)
    pick = torch.minimum((num_valid + 1) // 2, torch.clamp(num_valid - 1, min=0))
    val = torch.gather(s, -1, pick[..., None])[..., 0]
    filled = torch.where(torch.isfinite(val) & (num_valid > 0), 0.001 * val, 0.0)
    return torch.where(depth != 0.0, depth, filled)


def fill_depth_holes(depth: torch.Tensor, max_iters: int = 40):
    """Iterated median fill seeded from the bilateral-filtered map, stopping
    early when no holes remain (reference Depth2Normals.forward,
    depth_utils.py:84-94). Returns (filled (B, H, W), all_valid (B,) bool).

    As in the JAX package the decision covers the whole batch: if any frame
    has a hole, every frame is bilateral-filtered and iterated; a batch without
    holes passes through untouched."""
    if not _any(depth == 0.0):
        out = depth
    else:
        out = median_fill(bilateral_filter(depth))
        it = 0
        while it < max_iters and _any(out == 0.0):
            out = median_fill(out)
            it += 1
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
    n = torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)
    l2 = (n * n).sum(dim=-1, keepdim=True)
    ln = torch.sqrt(torch.clamp(l2, min=1e-24))
    some_valid = ((pts[..., 0] != 0) | (pc[..., 0] != 0) | (cp[..., 0] != 0)
                  | (mc[..., 0] != 0) | (cm[..., 0] != 0))
    out = torch.where((l2 > 0.0) & some_valid[..., None], n / -ln, 0.0)
    _, H, W, _ = pts.shape
    ys = torch.arange(H, device=pts.device)[None, :, None]
    xs = torch.arange(W, device=pts.device)[None, None, :]
    interior = (ys > 0) & (ys < H - 1) & (xs > 0) & (xs < W - 1)
    return torch.where(interior[..., None], out, 0.0)


def depth_to_normals(depth: torch.Tensor, intrinsics: torch.Tensor, max_fill_iters: int = 40):
    """The Depth2Normals chain (reference depth_utils.py:66-99): bilateral-seeded
    median hole fill -> camera-space unprojection -> cross normals. Returns
    (normals (B, H, W, 3), filled depth (B, H, W), all_valid (B,) bool)."""
    if max_fill_iters > 0:
        filled, all_valid = fill_depth_holes(depth, max_fill_iters)
    else:
        filled = depth
        all_valid = ~(depth.reshape(depth.shape[0], -1) == 0.0).any(dim=-1)
    pts = depth_to_camera_space(filled, intrinsics)
    return camera_space_normals(pts), filled, all_valid

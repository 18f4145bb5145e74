"""TSDF fusion (offline dataset generation): the PyTorch counterpart of
``spsg_tpu/datagen/fusion.py``, a rebuild of the reference datagen's
VoxelGrid integration (datagen/src/VoxelGrid.cpp:7-114, VoxelGrid.h:20-733)
that defines the training data formats.

Per-frame integration math (VoxelGrid.cpp:29-98):
  - project every voxel centre into the frame, nearest-pixel depth lookup;
  - valid depth in [0.4, 4.0] m; free-space counter++ where the voxel is in
    front of the observation;
  - sdf = d - p.z, adaptive truncation ``3*voxel + d*voxel``
    (VoxelGrid.h:32-34, 660-662); integrate when sdf > -truncation after
    clamping to +-truncation;
  - depth-dependent weight ``max(4.5 * (1 - (d - 0.4)/3.6), 1)``;
  - first observation sets sdf/color; later ones fold in with the running
    weighted average (color: fixed 0.5/0.5 blend with +0.5 rounding);
    weight accumulates, capped at 255.

:func:`integrate` updates the grid in place (the JAX package donates it to
its jitted update, the same contract). On a CUDA grid it launches the hand
kernel K8 (``ops/csrc/tsdf.cu``, one launch a frame); on a CPU grid it runs
:func:`integrate_plain`, the JAX package's arithmetic op for op in PyTorch.
The two agree to the bit: K8 is built with ``-fmad=false`` and rounds every
operation where the plain version does. The voxel -> camera map is computed
once a frame on the host in float32 (:func:`voxel_to_camera`)."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data import formats
from ..ops import _build
from ..training.state import resolve_device

# launches of K8 by its wrapper (and by nothing else)
launch_counts = {"tsdf_integrate": 0}
_libs = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    voxelsize: float = 0.02
    depth_min: float = 0.4  # Fuser.cpp:75 VoxelGrid(..., 0.4f, 4.0f)
    depth_max: float = 4.0
    scene_pad: int = 3  # GlobalAppState s_scenePadding (zParametersScanMP)
    height_pad: int = 3

    @property
    def truncation_m(self) -> float:
        return 3.0 * self.voxelsize  # VoxelGrid.h:32

    def adaptive_truncation(self, d):
        return self.truncation_m + d * self.voxelsize  # VoxelGrid.h:660-662


def make_grid(dims_zyx: Tuple[int, int, int], device="cuda") -> Dict[str, torch.Tensor]:
    """An empty grid on ``device``: sdf (Z,Y,X) -inf (meters), weight 0,
    color (Z,Y,X,3) 0, free_ctr int32 0."""
    device = resolve_device(device)
    z, y, x = dims_zyx
    return dict(
        sdf=torch.full((z, y, x), -float("inf"), dtype=torch.float32, device=device),
        weight=torch.zeros((z, y, x), dtype=torch.float32, device=device),
        color=torch.zeros((z, y, x, 3), dtype=torch.float32, device=device),
        free_ctr=torch.zeros((z, y, x), dtype=torch.int32, device=device),
    )


def grid_from_bounds(bounds_min, bounds_max, cfg: FusionConfig):
    """Grid dims + world2grid from world bounds (Fuser.cpp:48-52): dims =
    round(extent/voxel) + 2*pad; world2grid = scale(1/voxel) *
    translate(-min + pad*voxel)."""
    bounds_min = np.asarray(bounds_min, np.float64)
    bounds_max = np.asarray(bounds_max, np.float64)
    extent = bounds_max - bounds_min
    dims_xyz = np.round(extent / cfg.voxelsize).astype(int) + np.array(
        [2 * cfg.scene_pad, 2 * cfg.scene_pad, 2 * cfg.height_pad]
    )
    world2grid = np.eye(4, dtype=np.float32)
    pad = np.array([cfg.scene_pad, cfg.scene_pad, cfg.height_pad], np.float64)
    world2grid[:3, :3] *= 1.0 / cfg.voxelsize
    world2grid[:3, 3] = (-bounds_min + pad * cfg.voxelsize) / cfg.voxelsize
    dims_zyx = (int(dims_xyz[2]), int(dims_xyz[1]), int(dims_xyz[0]))
    return dims_zyx, world2grid


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def voxel_to_camera(cam2world, world2grid) -> np.ndarray:
    """M = inv(cam2world) @ inv(world2grid), (4, 4) float32, computed on the
    host in float32 (the JAX package inverts both on its device in float32:
    the two may differ by an ulp)."""
    grid2world = np.linalg.inv(_host(world2grid))
    world2cam = np.linalg.inv(_host(cam2world))
    return (world2cam @ grid2world).astype(np.float32)


def _frame_params(intrinsics, cam2world, world2grid, cfg: FusionConfig) -> list:
    """K8's 20 float32 scalars: rows 0-2 of M, fx, fy, mx, my, depth_min,
    depth_max, the truncation at depth 0 and the voxel size."""
    m = voxel_to_camera(cam2world, world2grid)
    intr = _host(intrinsics)
    consts = np.array([cfg.depth_min, cfg.depth_max, cfg.truncation_m, cfg.voxelsize],
                      np.float32)
    return [float(v) for v in np.concatenate([m[:3].ravel(), intr[:4], consts])]


# 1 / 3.6 in float32: XLA turns the reference's division by the constant 3.6
# into a product with this, and contracts 1 - x * c into one fused
# multiply-add (rounded once)
INV_DEPTH_RANGE = float(np.float32(1.0 / 3.6))


def one_minus_depth01(d: torch.Tensor) -> torch.Tensor:
    """``1 - (d - 0.4) / 3.6`` of the depth weight (VoxelGrid.cpp), rounded
    as the JAX package computes it: x = d - 0.4 in float32, then
    fma(-x, f32(1/3.6), 1), one rounding. x is a multiple of 2^-25 and the
    constant of 2^-23, so for x in [0, 3.6] the product and the difference
    are exact in float64 and the cast rounds once, as the FMA does (K8 calls
    fmaf)."""
    x = d - 0.4
    return (1.0 - x.double() * INV_DEPTH_RANGE).float()


def _project(shape, depth, intrinsics, cam2world, world2grid, cfg: FusionConfig):
    """The per-voxel projection of :func:`integrate_plain`: (pz, flat pixel
    index, nearest depth d, d_ok), each (Z, Y, X)."""
    Z, Y, X = shape
    H, W = depth.shape
    dev = depth.device
    zz, yy, xx = torch.meshgrid(
        torch.arange(Z, dtype=torch.float32, device=dev),
        torch.arange(Y, dtype=torch.float32, device=dev),
        torch.arange(X, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    M = voxel_to_camera(cam2world, world2grid).tolist()
    px = M[0][0] * xx + M[0][1] * yy + M[0][2] * zz + M[0][3]
    py = M[1][0] * xx + M[1][1] * yy + M[1][2] * zz + M[1][3]
    pz = M[2][0] * xx + M[2][1] * yy + M[2][2] * zz + M[2][3]

    fx, fy, mx, my = (float(v) for v in _host(intrinsics)[:4])
    safe_z = torch.where(pz.abs() > 1e-9, pz, pz.new_full((), 1e-9))
    # in_img is decided on the rounded float, before the int cast: out of the
    # int32 range XLA saturates and the CPU's cast wraps, but both are outside
    uf = torch.round(fx * px / safe_z + mx)
    vf = torch.round(fy * py / safe_z + my)
    in_img = (uf >= 0) & (vf >= 0) & (uf < W) & (vf < H) & (pz > 0)

    u = uf.clamp(0, W - 1).to(torch.int64)
    v = vf.clamp(0, H - 1).to(torch.int64)
    flat = v * W + u
    d = depth.reshape(-1)[flat]
    d_ok = in_img & torch.isfinite(d) & (d >= cfg.depth_min) & (d <= cfg.depth_max)
    return pz, flat, d, d_ok


def observed_voxels(shape, depth, intrinsics, cam2world, world2grid,
                    cfg: FusionConfig) -> int:
    """Voxels whose projection lands on a valid depth (``d_ok``): the state
    that one frame's integrate must read and write."""
    return int(_project(shape, depth, intrinsics, cam2world, world2grid, cfg)[3].sum())


def integrate_plain(grid, depth, color, intrinsics, cam2world, world2grid,
                    cfg: FusionConfig):
    """Plain PyTorch version of :func:`integrate` (any device), the JAX
    package's ``integrate`` op for op; updates ``grid`` in place."""
    pz, flat, d, d_ok = _project(grid["sdf"].shape, depth, intrinsics, cam2world,
                                 world2grid, cfg)
    free = d_ok & (pz < d)

    sdf = d - pz
    trunc = cfg.adaptive_truncation(d)
    upd = d_ok & (sdf > -trunc)
    sdf = torch.clamp(sdf, -trunc, trunc)
    w_upd = torch.clamp(3.0 * 1.5 * one_minus_depth01(d), min=1.0)

    old_sdf, old_w = grid["sdf"], grid["weight"]
    first = ~torch.isfinite(old_sdf)
    merged = (old_sdf * old_w + sdf * w_upd) / (old_w + w_upd)
    new_sdf = torch.where(upd, torch.where(first, sdf, merged), old_sdf)
    new_w = torch.where(upd, torch.clamp(old_w + w_upd, max=255.0), old_w)

    if color is not None:
        rgb = color.reshape(-1, 3)
        c = rgb[flat.clamp(max=rgb.shape[0] - 1)]
        old_c = grid["color"]
        blend = torch.floor(0.5 + 0.5 * old_c + 0.5 * c)  # VoxelGrid.cpp:96
        cnew = torch.where(first[..., None], c, blend)
        grid["color"].copy_(torch.where(upd[..., None], cnew, old_c))
    grid["sdf"].copy_(new_sdf)
    grid["weight"].copy_(new_w)
    grid["free_ctr"].add_(free.to(torch.int32))
    return grid


# ---------------------------------------------------------------------------
# K8: the CUDA kernel
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _libs.get("tsdf")
    if lib is None:
        lib = _build.load("tsdf")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spsg_tsdf_integrate.restype = i
        lib.spsg_tsdf_integrate.argtypes = [p] * 6 + [ctypes.c_longlong] + [i] * 5 + [p, p]
        _libs["tsdf"] = lib
    return lib


def _check(grid, depth, color):
    sdf = grid["sdf"]
    shape = tuple(sdf.shape)
    if sdf.dim() != 3 or depth.dim() != 2:
        raise ValueError(f"tsdf_integrate: grid (Z,Y,X) and depth (H,W), got {shape}, "
                         f"{tuple(depth.shape)}")
    want = dict(sdf=(shape, torch.float32), weight=(shape, torch.float32),
                color=(shape + (3,), torch.float32), free_ctr=(shape, torch.int32))
    for k, (s, dt) in want.items():
        t = grid[k]
        if tuple(t.shape) != s or t.dtype != dt:
            raise ValueError(f"tsdf_integrate: grid[{k!r}] must be {dt} {s}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if depth.dtype != torch.float32 or (color is not None and (
            color.dtype != torch.float32 or color.shape[-1] != 3)):
        raise ValueError("tsdf_integrate: depth and color must be float32, color (..., 3)")
    for t in (*grid.values(), depth, color):
        if t is not None and (t.device != sdf.device or not t.is_contiguous()):
            raise ValueError("tsdf_integrate: CUDA inputs must be contiguous and on one device")


def integrate(grid: Dict[str, torch.Tensor], depth: torch.Tensor,
              color: Optional[torch.Tensor], intrinsics, cam2world, world2grid,
              cfg: FusionConfig) -> Dict[str, torch.Tensor]:
    """Integrate one RGB-D frame into ``grid`` in place and return it.
    ``depth`` (H, W) meters, 0 / NaN invalid; ``color`` (H', W', 3) float
    [0, 255] or None, looked up with the depth image's flat index clipped to
    its own length; ``intrinsics`` (fx, fy, mx, my), ``cam2world`` and
    ``world2grid`` (4, 4) on the host or the device. A CUDA grid launches K8
    (a failed build or launch raises), a CPU grid takes :func:`integrate_plain`."""
    sdf = grid["sdf"]
    if sdf.device.type == "cpu":
        return integrate_plain(grid, depth, color, intrinsics, cam2world, world2grid, cfg)
    if sdf.device.type != "cuda":
        raise ValueError(f"tsdf_integrate: unsupported device {sdf.device}")
    _check(grid, depth, color)
    Z, Y, X = sdf.shape
    H, W = depth.shape
    params = (ctypes.c_float * 20)(*_frame_params(intrinsics, cam2world, world2grid, cfg))
    n_rgb = 0 if color is None else color.numel() // 3
    with torch.cuda.device(sdf.device):
        err = _library().spsg_tsdf_integrate(
            sdf.data_ptr(), grid["weight"].data_ptr(), grid["color"].data_ptr(),
            grid["free_ctr"].data_ptr(), depth.data_ptr(),
            None if color is None else color.data_ptr(), n_rgb, Z, Y, X, H, W,
            ctypes.cast(params, ctypes.c_void_p),
            torch.cuda.current_stream(sdf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tsdf_integrate: CUDA launch failed with error {err} for "
                           f"{(Z, Y, X)}, image {(H, W)}")
    launch_counts["tsdf_integrate"] += 1
    return grid


def known_encoding(sdf_m: np.ndarray, voxelsize: float) -> np.ndarray:
    """.knw encoding (VoxelGrid.h saveKnownToFile:321-340):
    0 = known-empty (sdf > voxel), 1 = known-occupied (|sdf| <= voxel),
    >=2 = unknown-by-distance (clamped 255); unobserved -> 255."""
    sdf_m = np.asarray(sdf_m)
    known = np.zeros(sdf_m.shape, np.uint8)
    behind = sdf_m < -voxelsize
    with np.errstate(invalid="ignore"):
        dist = np.where(np.isfinite(sdf_m), -sdf_m / voxelsize, 254.0)
    known[behind] = np.clip(dist[behind] + 1.0, 2, 255).astype(np.uint8)
    known[(sdf_m >= -voxelsize) & (sdf_m <= voxelsize)] = 1
    known[~np.isfinite(sdf_m)] = 255
    return known


def save_grid(
    prefix: str,
    grid: Dict[str, torch.Tensor],
    world2grid: np.ndarray,
    cfg: FusionConfig,
    save_trunc_factor: float = 6.0,  # Fuser.cpp:35
    save_colors: bool = True,
    save_known: bool = True,
) -> None:
    """Write <prefix>.sdf (+.colors, +.knw) in the reference formats; the
    grid's sdf (and colour) are copied to the host once."""
    sdf_m = grid["sdf"].cpu().numpy()
    dims = sdf_m.shape
    with np.errstate(invalid="ignore"):
        mask = np.isfinite(sdf_m) & (np.abs(sdf_m) <= save_trunc_factor * cfg.voxelsize)
    locs = np.argwhere(mask).astype(np.int32)
    vals_m = sdf_m[mask]
    formats.save_sdf(
        prefix + ".sdf",
        dims,
        cfg.voxelsize,
        world2grid,
        locs,
        vals_m / cfg.voxelsize,  # save_sdf re-multiplies by voxelsize
    )
    if save_colors:
        colors = np.clip(grid["color"].cpu().numpy(), 0, 255).astype(np.uint8)
        formats.save_colors_sparse(prefix + ".colors", dims, colors[mask])
    if save_known:
        formats.save_known(
            prefix + ".knw", known_encoding(sdf_m, cfg.voxelsize), cfg.voxelsize, world2grid
        )


def fuse_frames(
    dims_zyx,
    world2grid,
    frames,  # iterable of (depth (H,W) m, color (H,W,3) u8 or None, intrinsics (4,), cam2world (4,4))
    cfg: FusionConfig = FusionConfig(),
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Fuse a frame sequence into a fresh grid on ``device`` (Fuser::fuse
    inner loop, Fuser.cpp:82-95); each frame's images are uploaded once."""
    grid = make_grid(dims_zyx, device)
    dev = grid["sdf"].device
    for depth, color, intrinsics, cam2world in frames:
        integrate(
            grid,
            torch.as_tensor(np.asarray(depth, np.float32), device=dev),
            torch.as_tensor(np.asarray(color, np.float32), device=dev)
            if color is not None else None,
            intrinsics, cam2world, world2grid, cfg,
        )
    return grid

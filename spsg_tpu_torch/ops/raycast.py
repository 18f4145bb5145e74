"""Differentiable TSDF raycaster (PyTorch counterpart of
``spsg_tpu/ops/raycast.py``; reference CUDA kernel
torch/utils/raycast_rgbd/raycast_rgbd_cuda_kernel.cu).

Renders a batched dense TSDF volume with per-voxel colour / normal / semantic
attributes into per-view images, with the JAX package's semantics:

  * pinhole rays ``normalize(((x-mx)/fx, (y-my)/fy, 1))`` rotated by the
    camera->grid view matrix;
  * samples on the fixed lattice ``t0 + k * ray_increment`` (k = 0 is the
    first sample), clipped to the box of valid voxels; a crossing is a sign
    change of the trilinearly interpolated SDF between consecutive samples
    whose 8 corners are all valid, refined by 3 bisections;
  * attributes from the nearest voxel of the refined hit; invalid pixels are
    ``-inf``, and a hit whose voxel normal is exactly zero keeps a ``-inf``
    normal; depth is camera z in voxels;
  * the backward scatters each pixel's gradient to its hit voxel, averaged
    over all pixels that hit it (no 64-pixel cap); the depth gradient goes to
    the voxel's SDF; nothing flows to the march, the view or the intrinsics.

Four hand-written CUDA kernels (``csrc/raycast.cu``) carry it on a card; none
replaces a Pallas kernel (the JAX package left the raycaster to XLA):

  * :func:`march` (K4, ``raycast_march_map_kernel`` + ``raycast_march_kernel``):
    a pre-pass marks every fully valid cell with a bit and every 8^3 coarse
    block that holds one with a flag (:func:`coarse_blocks_plain`); then one
    thread per ray (a warp an 8x4 pixel tile) walks the lattice to its first
    crossing, loading corners (from ``sdf`` alone) only for samples whose cell
    is fully valid, bisects and picks the nearest voxel. The lockstep loop of
    the JAX package, translated op for op, would read an "any ray alive" flag
    back to the host at every iteration;
  * :func:`shade` (K5, ``raycast_shade_kernel``): the gather of the forward,
    a block a run of consecutive pixels: their rows staged in shared memory,
    then each output's span of the block gathered and written in order;
  * :func:`scatter` (K6, ``raycast_scatter_zero_kernel``,
    ``raycast_scatter_kernel``, ``raycast_scatter_finalize_kernel``): the
    averaged scatter of the backward: the first pixel to hit a voxel owns it,
    every pixel of the voxel adds into the owner's row, and one pass over the
    voxels writes each gradient once, divided by the count;
  * :func:`occ_march` (K7, ``raycast_occ_kernel``), behind :func:`raycast_occ`:
    the binary occupancy image of the missing-colour weights, one thread per
    ray walking the lattice to its first sample whose nearest voxel is
    occupied (the JAX package's lockstep loop would read "is any ray still
    marching" back to the host at every round).

Each has its plain PyTorch version beside it (``*_plain``). Dispatch is by
where the tensors live and by nothing else: a CUDA tensor launches the kernel
or raises, a CPU tensor takes the plain version. The ray set-up (camera rays,
the box of valid voxels, ``t0``, ``t_stop``) is shared PyTorch code that both
consume. Of the JAX package's march schedules, K4 has the coarse skip (with
the block edge fixed at the JAX package's default of 8) and the plain march
has none; straggler and cross-batch compaction and batch groups are not
here. The JAX package's tests hold each of them bit-identical to its plain
march, and the fields that steer them have no counterpart in
:class:`RaycastConfig`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from . import _build

NEG_INF = -float("inf")
NUM_CLASSES = 14
# gradient channels of the scatter: colour 3, normal 3, semantic 14, depth 1;
# then the count of hitting pixels
N_GRAD = 3 + 3 + NUM_CLASSES + 1
# edge in voxels of K4's coarse blocks (kEdge in csrc/raycast.cu)
COARSE_BLOCK = 8
# floats in K6's per-pixel row of sums: 21 channels, the count, padding (kRow)
SCATTER_ROW = 24

# launches of each kernel by its wrapper (and by nothing else)
launch_counts = {"raycast_march": 0, "raycast_shade": 0, "raycast_scatter": 0,
                 "raycast_occ": 0}
_libs = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    """Raycast parameters (reference train.py:134-148). Depth units are voxels
    (the caller divides depth_min/depth_max by the voxel size)."""

    width: int = 320
    height: int = 256
    depth_min: float = 0.1 / 0.02
    depth_max: float = 6.0 / 0.02
    ray_increment: float = 0.9  # 0.3 * truncation
    thresh_sample_dist: float = 50.5 * 0.9
    max_dir_slack: float = 1.45  # bounds depthToRayLength for the sample cap
    bisection_iters: int = 3
    march_block: int = 32  # sets the sample cap (max_samples)

    @property
    def max_samples(self) -> int:
        """Samples a ray takes at most beyond k = 0: the JAX package's plain
        march runs at most ``n_iter_max`` blocks of ``march_block`` samples. It
        never binds in practice (the box clipping ends the rays first)."""
        span = (self.depth_max - self.depth_min) * self.max_dir_slack
        n_iter_max = int(math.ceil(span / (self.ray_increment * self.march_block))) + 1
        return n_iter_max * self.march_block


class RaycastOutput(NamedTuple):
    color: torch.Tensor  # (B, H, W, 3), -inf invalid
    depth: torch.Tensor  # (B, H, W), -inf invalid, voxel units
    normal: torch.Tensor  # (B, H, W, 3), -inf invalid
    semantic: torch.Tensor  # (B, H, W, 14), -inf invalid


# ---------------------------------------------------------------------------
# ray set-up (shared by the kernel and the plain march)
# ---------------------------------------------------------------------------


def _div(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` rounded once. A Python scalar divisor would let PyTorch's CUDA
    kernel multiply by its reciprocal instead, which rounds twice. The divisor
    is filled on the device: a copy from the host would wait for the stream."""
    return a / a.new_full((), s)


def _rdiv(s: float, a: torch.Tensor) -> torch.Tensor:
    """``s / a`` rounded once (``s / tensor`` is ``reciprocal(a) * s``)."""
    return a.new_full((), s) / a


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, summed left to right."""
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2])


def _camera_rays(view, intrinsics, width, height):
    """Per-pixel grid-space rays. view (B,4,4) cam->grid, intrinsics (B,4) =
    [fx, fy, mx, my]. Returns (origin (B,3), direction (B,P,3) normalised,
    cam_z (B,P) = z of the normalised camera ray, i.e. 1/depthToRayLength)."""
    dev = view.device
    px = torch.arange(width, dtype=torch.float32, device=dev)
    py = torch.arange(height, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(py, px, indexing="ij")  # (H, W)
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)
    fx, fy, mx, my = (intrinsics[:, i][:, None] for i in range(4))
    cx = (gx[None, :] - mx) / fx
    cy = (gy[None, :] - my) / fy
    cam_dir = torch.stack([cx, cy, torch.ones_like(cx)], dim=-1)
    cam_dir = cam_dir / _norm3(cam_dir)[..., None]
    cam_z = cam_dir[..., 2]
    rot = view[:, :3, :3]
    origin = view[:, :3, 3]
    # the 3-term products summed left to right
    world_dir = torch.stack([
        (rot[:, i, 0, None] * cam_dir[..., 0] + rot[:, i, 1, None] * cam_dir[..., 1])
        + rot[:, i, 2, None] * cam_dir[..., 2] for i in range(3)], dim=-1)
    world_dir = world_dir / _norm3(world_dir)[..., None]
    return origin, world_dir, cam_z


def _valid_bounds(valid):
    """Per-batch xyz bounds of the valid voxels, widened by 1.5: (lo, hi)
    (B, 3). Rays are clipped to this box, not to the whole grid."""
    B, Z, Y, X = valid.shape

    def lo_hi(v, n):
        idx = torch.arange(n, dtype=torch.float32, device=valid.device)
        lo = torch.where(v, idx, float(n)).amin(dim=1)
        hi = torch.where(v, idx, -1.0).amax(dim=1)
        return lo, hi

    zlo, zhi = lo_hi(valid.any(dim=3).any(dim=2), Z)
    ylo, yhi = lo_hi(valid.any(dim=3).any(dim=1), Y)
    xlo, xhi = lo_hi(valid.any(dim=2).any(dim=1), X)
    lo = torch.stack([xlo, ylo, zlo], dim=-1) - 1.5
    hi = torch.stack([xhi, yhi, zhi], dim=-1) + 1.5
    return lo, hi


def _ray_aabb(origin, direction, lo, hi):
    """Per-ray [t_enter, t_exit] against a per-batch box (slab method)."""
    o = origin[:, None, :]
    d = direction
    big = d.abs() > 1e-9
    inv = torch.where(big, torch.ones_like(d) / torch.where(big, d, 1.0), 1e12)
    t0 = (lo[:, None, :] - o) * inv
    t1 = (hi[:, None, :] - o) * inv
    return torch.minimum(t0, t1).amax(dim=-1), torch.maximum(t0, t1).amin(dim=-1)


class MarchSetup(NamedTuple):
    origin: torch.Tensor  # (B, 3)
    direction: torch.Tensor  # (B, P, 3)
    cam_z: torch.Tensor  # (B, P)
    t0: torch.Tensor  # (B, P) ray length of sample k = 0, on the global lattice
    t_stop: torch.Tensor  # (B, P) samples beyond it are not taken


def march_setup(valid, view, intrinsics, cfg: RaycastConfig) -> MarchSetup:
    """Rays, and the stretch of each that the march walks: from the box of
    valid voxels (snapped down to the lattice of ``depth_min / cam_z + k *
    ray_increment``) to its exit plus one step, within [depth_min, depth_max]."""
    origin, direction, cam_z = _camera_rays(view, intrinsics, cfg.width, cfg.height)
    t_start = _rdiv(cfg.depth_min, cam_z)
    t_end = _rdiv(cfg.depth_max, cam_z)
    lo, hi = _valid_bounds(valid)
    t_enter, t_exit = _ray_aabb(origin, direction, lo, hi)
    skip = torch.clamp(torch.floor(_div(t_enter - t_start, cfg.ray_increment)), min=0.0)
    t0 = t_start + skip * cfg.ray_increment
    t_stop = torch.minimum(t_end, t_exit + cfg.ray_increment)
    return MarchSetup(origin.contiguous(), direction.contiguous(), cam_z.contiguous(),
                      t0.contiguous(), t_stop.contiguous())


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of a library built from ``csrc/raycast.cu``. K7
    (``spsg_raycast_occ``) is bound where the library has it, so that an
    older ``raycast.cu`` without it binds too (``chip_smoke.py
    --baseline-raycast-source``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.spsg_raycast_march.restype = i
    lib.spsg_raycast_march.argtypes = [p] * 15 + [i] * 6 + [f, f, i, i, p]
    lib.spsg_raycast_shade.restype = i
    lib.spsg_raycast_shade.argtypes = [p] * 10 + [i] * 3 + [p]
    lib.spsg_raycast_scatter.restype = i
    lib.spsg_raycast_scatter.argtypes = [p] * 11 + [i] * 3 + [p]
    if hasattr(lib, "spsg_raycast_occ"):
        lib.spsg_raycast_occ.restype = i
        lib.spsg_raycast_occ.argtypes = [p] * 7 + [i] * 6 + [f, i, p]
    return lib


def _library() -> ctypes.CDLL:
    lib = _libs.get("raycast")
    if lib is None:
        lib = _libs["raycast"] = _bind(_build.load("raycast"))
    return lib


def _device_kind(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_cuda(what, *tensors):
    dev = next(t.device for t in tensors if t is not None)
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: CUDA inputs must be contiguous and on one device")


def _raise_on(err: int, what: str, shape) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} for {tuple(shape)}")


# ---------------------------------------------------------------------------
# K4: the march
# ---------------------------------------------------------------------------


def _check_grid(sdf, valid):
    if sdf.dim() != 4 or tuple(valid.shape) != tuple(sdf.shape):
        raise ValueError(f"raycast: sdf and valid must be (B,Z,Y,X), got "
                         f"{tuple(sdf.shape)} and {tuple(valid.shape)}")
    if sdf.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"raycast: sdf float32 and valid bool, got {sdf.dtype}, {valid.dtype}")


def march(sdf: torch.Tensor, valid: torch.Tensor, setup: MarchSetup, cfg: RaycastConfig,
          samples: Optional[torch.Tensor] = None, evaluated: Optional[torch.Tensor] = None):
    """First surface crossing of every ray: (hit (B,P) bool, alpha (B,P) ray
    length, depth (B,P) camera z, hit_idx (B,P) int32 flat voxel index of the
    nearest voxel). CUDA tensors go to the kernel, CPU tensors to
    :func:`march_plain`. No gradient. On a card, int32 (B,P) ``samples`` and
    ``evaluated`` receive, per ray, the lattice index at exit (the samples a
    march without the coarse skip evaluates) and the samples that loaded
    corners (to measure the work; :func:`march_work_plain` counts both)."""
    _check_grid(sdf, valid)
    if _device_kind(sdf, "raycast_march") == "cpu":
        return march_plain(sdf, valid, setup, cfg)
    B, Z, Y, X = sdf.shape
    P = setup.t0.shape[1]
    if P % cfg.width:
        raise ValueError(f"raycast_march: {P} rays a row is not a multiple of width {cfg.width}")
    _check_cuda("raycast_march", sdf, valid, *setup)
    dev = sdf.device
    nb = _coarse_dims(Z, Y, X)
    blocks = torch.empty((B,) + nb, dtype=torch.uint8, device=dev)
    # per block, its cells' bits (COARSE_BLOCK^3 of them) in int32 words
    cells = torch.empty((B,) + nb + (COARSE_BLOCK ** 3 // 32,), dtype=torch.int32, device=dev)
    hit = torch.empty((B, P), dtype=torch.bool, device=dev)
    alpha = torch.empty((B, P), dtype=torch.float32, device=dev)
    depth = torch.empty((B, P), dtype=torch.float32, device=dev)
    hit_idx = torch.empty((B, P), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _library().spsg_raycast_march(
            sdf.data_ptr(), valid.data_ptr(), *(t.data_ptr() for t in setup),
            blocks.data_ptr(), cells.data_ptr(),
            hit.data_ptr(), alpha.data_ptr(), depth.data_ptr(), hit_idx.data_ptr(),
            _ptr(samples), _ptr(evaluated), B, Z, Y, X, P, cfg.width, cfg.ray_increment,
            cfg.thresh_sample_dist, cfg.max_samples, cfg.bisection_iters, _stream(sdf))
    _raise_on(err, "raycast_march", sdf.shape)
    launch_counts["raycast_march"] += 1
    return hit, alpha, depth, hit_idx


def _coarse_dims(Z, Y, X):
    return tuple(-(-n // COARSE_BLOCK) for n in (Z, Y, X))


def _cell_ok(sdf, valid):
    """(B, Z-1, Y-1, X-1): the cell at each base corner is fully valid (all 8
    corners valid and finite)."""
    ok = valid & torch.isfinite(sdf)
    cell = ok[:, :-1, :-1, :-1].clone()
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                cell &= ok[:, dz:dz + ok.shape[1] - 1, dy:dy + ok.shape[2] - 1,
                           dx:dx + ok.shape[3] - 1]
    return cell


def coarse_blocks_plain(sdf, valid):
    """Plain PyTorch version of K4's block map: (B, nbz, nby, nbx) bool, a
    block of COARSE_BLOCK^3 cells (by base corner; ceil(dim / COARSE_BLOCK)
    blocks an axis) holds a fully valid cell. A lattice sample whose cell lies
    in a block without one is NaN, so the kernel loads nothing for it (the
    JAX package's build_block_windows of its cell_ok)."""
    _check_grid(sdf, valid)
    B, Z, Y, X = sdf.shape
    nb = _coarse_dims(Z, Y, X)
    e = COARSE_BLOCK
    cell = torch.zeros((B,) + tuple(n * e for n in nb), dtype=torch.bool, device=sdf.device)
    cell[:, :Z - 1, :Y - 1, :X - 1] = _cell_ok(sdf, valid)
    return cell.reshape(B, nb[0], e, nb[1], e, nb[2], e).any(dim=6).any(dim=4).any(dim=2)


def _flat_index(ix, iy, iz, dims):
    Z, Y, X = dims
    return (iz * Y + iy) * X + ix


def _trilerp(sdf_flat, valid_flat, px, py, pz, dims):
    """Trilinear SDF at (B, ...) positions, NaN where any of the 8 corners is
    invalid (or not finite) or the cell leaves the grid; corner weights and
    their sum in the JAX package's order (w000*c0 + ... + w111*c7)."""
    Z, Y, X = dims
    B = px.shape[0]
    bx, by, bz = torch.floor(px), torch.floor(py), torch.floor(pz)
    wx, wy, wz = px - bx, py - by, pz - bz
    ix, iy, iz = bx.to(torch.int64), by.to(torch.int64), bz.to(torch.int64)
    inb = (ix >= 0) & (iy >= 0) & (iz >= 0) & (ix < X - 1) & (iy < Y - 1) & (iz < Z - 1)
    idx = torch.where(inb, _flat_index(ix, iy, iz, dims), 0).reshape(B, -1)
    ok = inb.reshape(B, -1)
    corners = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                j = idx + (dz * Y * X + dy * X + dx)
                c = torch.gather(sdf_flat, 1, j)
                ok = ok & torch.gather(valid_flat, 1, j) & torch.isfinite(c)
                corners.append(c.reshape(px.shape))
    w = [(1 - wx) * (1 - wy) * (1 - wz), wx * (1 - wy) * (1 - wz),
         (1 - wx) * wy * (1 - wz), wx * wy * (1 - wz),
         (1 - wx) * (1 - wy) * wz, wx * (1 - wy) * wz,
         (1 - wx) * wy * wz, wx * wy * wz]
    val = w[0] * corners[0]
    for wk, ck in zip(w[1:], corners[1:]):
        val = val + wk * ck
    ok = ok.reshape(px.shape) & torch.isfinite(val)
    return torch.where(ok, val, torch.nan), ok


def march_plain(sdf, valid, setup: MarchSetup, cfg: RaycastConfig):
    """Plain PyTorch version of :func:`march` (any device): the JAX package's
    plain march, all rays in lockstep, ``march_block`` lattice samples a
    round; it stops when no ray is left (a host read per round on a card)."""
    _check_grid(sdf, valid)
    B, Z, Y, X = sdf.shape
    dims = (Z, Y, X)
    sdf_flat = sdf.reshape(B, -1)
    valid_flat = valid.reshape(B, -1)
    origin, direction, cam_z, t0, t_stop = setup
    P = t0.shape[1]
    ox, oy, oz = (origin[:, None, i] for i in range(3))
    dx, dy, dz = (direction[..., i] for i in range(3))
    step = cfg.ray_increment

    def sample(t):
        if t.dim() == 3:
            px = ox[..., None] + t * dx[..., None]
            py = oy[..., None] + t * dy[..., None]
            pz = oz[..., None] + t * dz[..., None]
        else:
            px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        return _trilerp(sdf_flat, valid_flat, px, py, pz, dims)

    F_ = cfg.march_block
    offs = torch.arange(F_, dtype=torch.float32, device=sdf.device)
    prev = sample(t0)[0]
    found = torch.zeros((B, P), dtype=torch.bool, device=sdf.device)
    t_lo, d_lo, t_hi, d_hi = (torch.zeros((B, P), device=sdf.device) for _ in range(4))
    k = torch.ones((B, P), device=sdf.device)  # sample 0 is prev
    for _ in range(cfg.max_samples // F_):
        alive = ~found & (t0 + k * step <= t_stop)
        if not bool(alive.any()):
            break
        # t from the exact integer sample index: the same float t as the kernel's
        treal = t0[..., None] + (k[..., None] + offs) * step
        in_range = treal <= t_stop[..., None]
        dead = found | (t0 + k * step > t_stop)
        t = torch.where(dead[..., None], t0[..., None], treal)
        v = sample(t)[0]
        prev_v = torch.cat([prev[..., None], v[..., :-1]], dim=-1)
        # NaN compares False, so both samples are valid where this holds
        crossing = (in_range & (prev_v * v < 0)
                    & ((prev_v - v).abs() < cfg.thresh_sample_dist)
                    & (v.abs() < cfg.thresh_sample_dist))
        any_cross = crossing.any(dim=-1)
        first = torch.argmax(crossing.to(torch.uint8), dim=-1, keepdim=True)
        t_hit = torch.gather(treal, -1, first)[..., 0]
        record = any_cross & ~found
        t_lo = torch.where(record, t_hit - step, t_lo)
        d_lo = torch.where(record, torch.gather(prev_v, -1, first)[..., 0], d_lo)
        t_hi = torch.where(record, t_hit, t_hi)
        d_hi = torch.where(record, torch.gather(v, -1, first)[..., 0], d_hi)
        found = found | record
        k = k + float(F_)
        prev = v[..., -1]

    # bisection (kernel findIntersectionBisection :166-187)
    a, da, b, db = t_lo, d_lo, t_hi, d_hi
    ok_bis = found
    cmid = b
    for _ in range(cfg.bisection_iters):
        diff = da - db
        denom = torch.where(diff.abs() > 1e-12, diff, 1e-12)
        cmid = a + (da / denom) * (b - a)
        dmid, okm = sample(cmid)
        ok_bis = ok_bis & okm
        dmid = torch.where(okm, dmid, 0.0)
        go_a = da * dmid > 0
        a = torch.where(go_a, cmid, a)
        da = torch.where(go_a, dmid, da)
        b = torch.where(go_a, b, cmid)
        db = torch.where(go_a, db, dmid)
    alpha = cmid

    # nearest voxel of the refined position
    ix = torch.floor(ox + alpha * dx + 0.5).to(torch.int64)
    iy = torch.floor(oy + alpha * dy + 0.5).to(torch.int64)
    iz = torch.floor(oz + alpha * dz + 0.5).to(torch.int64)
    inb = (ix >= 0) & (iy >= 0) & (iz >= 0) & (ix < X) & (iy < Y) & (iz < Z)
    idx = _flat_index(ix.clamp(0, X - 1), iy.clamp(0, Y - 1), iz.clamp(0, Z - 1), dims)
    hit = found & ok_bis & inb & torch.gather(valid_flat, 1, idx)
    return hit, alpha, alpha * cam_z, idx.to(torch.int32)


def march_work_plain(sdf, valid, setup: MarchSetup, cfg: RaycastConfig):
    """The march's work per ray, counted in plain PyTorch on the lattice of
    :func:`march_plain` (any device; a host read a round): ``samples``, the
    lattice index at exit (k = 0 included: the crossing's k + 1, or the first
    k beyond ``t_stop`` or the cap), which is what K4 writes to ``samples``;
    ``in_blocks``, of those the samples whose cell lies in the grid in a
    coarse block with a fully valid cell (:func:`coarse_blocks_plain`);
    ``fully_valid``, of those the samples whose cell is fully valid, the
    least any march must interpolate and what K4 writes to ``evaluated``.
    Each (B,P) int64."""
    _check_grid(sdf, valid)
    B, Z, Y, X = sdf.shape
    dims = (Z, Y, X)
    dev = sdf.device
    sdf_flat = sdf.reshape(B, -1)
    valid_flat = valid.reshape(B, -1)
    cell_ok = _cell_ok(sdf, valid).reshape(B, -1)
    occ = coarse_blocks_plain(sdf, valid).reshape(B, -1)
    nbz, nby, nbx = _coarse_dims(Z, Y, X)
    origin, direction, _, t0, t_stop = setup
    P = t0.shape[1]
    ox, oy, oz = (origin[:, None, i, None] for i in range(3))
    dx, dy, dz = (direction[..., i, None] for i in range(3))
    step = cfg.ray_increment
    F_ = cfg.march_block
    rows = torch.arange(B, device=dev)[:, None, None]
    samples = torch.zeros((B, P), dtype=torch.int64, device=dev)
    in_blocks = torch.zeros_like(samples)
    fully_valid = torch.zeros_like(samples)
    done = torch.zeros((B, P), dtype=torch.bool, device=dev)
    prev = torch.full((B, P), float("nan"), device=dev)
    k0 = 0
    while not bool(done.all()):
        ks = torch.arange(k0, k0 + F_, device=dev)
        t = t0[..., None] + ks.to(torch.float32) * step
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        v = _trilerp(sdf_flat, valid_flat, px, py, pz, dims)[0]
        ix, iy, iz = (torch.floor(q).to(torch.int64) for q in (px, py, pz))
        inb = (ix >= 0) & (iy >= 0) & (iz >= 0) & (ix < X - 1) & (iy < Y - 1) & (iz < Z - 1)
        ix, iy, iz = (torch.where(inb, q, 0) for q in (ix, iy, iz))
        blk = ((iz // COARSE_BLOCK) * nby + iy // COARSE_BLOCK) * nbx + ix // COARSE_BLOCK
        in_blk = inb & occ[rows, blk]
        full = inb & cell_ok[rows, (iz * (Y - 1) + iy) * (X - 1) + ix]
        prev_v = torch.cat([prev[..., None], v[..., :-1]], dim=-1)
        crossing = ((ks <= cfg.max_samples) & (t <= t_stop[..., None]) & (prev_v * v < 0)
                    & ((prev_v - v).abs() < cfg.thresh_sample_dist)
                    & (v.abs() < cfg.thresh_sample_dist))
        ends = (ks >= 1) & (crossing | ~(t <= t_stop[..., None]) | (ks > cfg.max_samples))
        first = torch.argmax(ends.to(torch.uint8), dim=-1, keepdim=True)
        exit_k = ks[first[..., 0]] + torch.gather(crossing, -1, first)[..., 0].long()
        newly = ends.any(dim=-1) & ~done
        limit = torch.where(done, -1, torch.where(newly, exit_k, k0 + F_))
        counted = ks < limit[..., None]
        in_blocks += (in_blk & counted).sum(dim=-1)
        fully_valid += (full & counted).sum(dim=-1)
        samples = torch.where(newly, exit_k, samples)
        done |= newly
        prev = v[..., -1]
        k0 += F_
    return dict(samples=samples, in_blocks=in_blocks, fully_valid=fully_valid)


def find_surface_crossings(sdf, valid, view, intrinsics, cfg: RaycastConfig):
    """Non-differentiable surface search: dict of per-pixel ``hit`` (B,P)
    bool, ``alpha`` (B,P) ray length, ``depth`` (B,P) camera z and
    ``hit_idx`` (B,P) int32."""
    with torch.no_grad():
        setup = march_setup(valid, view, intrinsics, cfg)
        hit, alpha, depth, hit_idx = march(sdf.detach().contiguous(), valid.contiguous(),
                                           setup, cfg)
    return dict(hit=hit, alpha=alpha, depth=depth, hit_idx=hit_idx)


# ---------------------------------------------------------------------------
# K5: the shade (forward gather)
# ---------------------------------------------------------------------------


def shade(color, normal, semantic, hit, hit_idx, depth):
    """Pixel attributes from the hit voxels. color / normal (B,N,3), semantic
    (B,N,14), each None for zeros; hit, hit_idx, depth (B,P). Returns
    (color (B,P,3), depth (B,P), normal (B,P,3), semantic (B,P,14)), -inf where
    there is no hit, and a -inf normal where the voxel's normal is zero. CUDA
    tensors go to the kernel, CPU tensors to :func:`shade_plain`; the two
    give the same outputs to the bit (a copy and a select, NaN and inf copied
    as they are)."""
    if _device_kind(hit, "raycast_shade") == "cpu":
        return shade_plain(color, normal, semantic, hit, hit_idx, depth)
    B, P = hit.shape
    present = [a for a in (color, normal, semantic) if a is not None]
    N = present[0].shape[1] if present else 1
    _check_cuda("raycast_shade", color, normal, semantic, hit, hit_idx, depth)
    dev = hit.device
    out_c = torch.empty((B, P, 3), device=dev)
    out_n = torch.empty((B, P, 3), device=dev)
    out_s = torch.empty((B, P, NUM_CLASSES), device=dev)
    out_d = torch.empty((B, P), device=dev)
    with torch.cuda.device(dev):
        err = _library().spsg_raycast_shade(
            _ptr(color), _ptr(normal), _ptr(semantic), hit.data_ptr(), hit_idx.data_ptr(),
            depth.data_ptr(), out_c.data_ptr(), out_n.data_ptr(), out_s.data_ptr(),
            out_d.data_ptr(), B, N, P, _stream(hit))
    _raise_on(err, "raycast_shade", hit.shape)
    launch_counts["raycast_shade"] += 1
    return out_c, out_d, out_n, out_s


def shade_plain(color, normal, semantic, hit, hit_idx, depth):
    """Plain PyTorch version of :func:`shade` (any device)."""
    B, P = hit.shape
    idx = hit_idx.long()

    def gather(vals, nc):
        if vals is None:
            return torch.zeros((B, P, nc), device=hit.device)
        return torch.gather(vals, 1, idx[..., None].expand(B, P, nc))

    c = torch.where(hit[..., None], gather(color, 3), NEG_INF)
    s = torch.where(hit[..., None], gather(semantic, NUM_CLASSES), NEG_INF)
    n = gather(normal, 3)
    nz = (n != 0.0).any(dim=-1)
    n = torch.where((hit & nz)[..., None], n, NEG_INF)
    d = torch.where(hit, depth, NEG_INF)
    return c, d, n, s


# ---------------------------------------------------------------------------
# K6: the scatter (backward)
# ---------------------------------------------------------------------------


def scatter(g_color, g_normal, g_semantic, g_depth, hit, hit_idx, n_voxels: int):
    """Backward of :func:`shade`: every hit pixel adds its cotangents (colour
    3, normal 3, semantic 14, depth 1; each None for zeros; a non-finite entry
    counts as 0) and a count of 1 into its voxel, in float32; each voxel's sums
    are divided by max(count, 1). Returns (d_sdf (B,N), d_color (B,N,3),
    d_normal (B,N,3), d_semantic (B,N,14)). CUDA tensors go to the kernels
    (atomic adds into a row of the pixel that owns the voxel, then every
    gradient written once, divided by the count: not bitwise repeatable), CPU
    tensors to :func:`scatter_plain`."""
    if _device_kind(hit, "raycast_scatter") == "cpu":
        return scatter_plain(g_color, g_normal, g_semantic, g_depth, hit, hit_idx, n_voxels)
    B, P = hit.shape
    _check_cuda("raycast_scatter", g_color, g_normal, g_semantic, g_depth, hit, hit_idx)
    for g in (g_color, g_normal, g_semantic, g_depth):
        if g is not None and g.dtype != torch.float32:
            raise TypeError(f"raycast_scatter: float32 cotangents, got {g.dtype}")
    dev = hit.device
    # zeroed by the kernels: a slot per voxel (its owner pixel), rounded up to
    # 16 bytes, then a row of 24 floats per pixel (the sums of the voxel it owns)
    scratch = torch.empty(-(-B * n_voxels // 4) * 4 + B * P * SCATTER_ROW, dtype=torch.int32,
                          device=dev)
    d_sdf = torch.empty((B, n_voxels), device=dev)
    d_c = torch.empty((B, n_voxels, 3), device=dev)
    d_n = torch.empty((B, n_voxels, 3), device=dev)
    d_s = torch.empty((B, n_voxels, NUM_CLASSES), device=dev)
    with torch.cuda.device(dev):
        err = _library().spsg_raycast_scatter(
            _ptr(g_color), _ptr(g_normal), _ptr(g_semantic), _ptr(g_depth),
            hit.data_ptr(), hit_idx.data_ptr(), scratch.data_ptr(), d_sdf.data_ptr(),
            d_c.data_ptr(), d_n.data_ptr(), d_s.data_ptr(), B, n_voxels, P, _stream(hit))
    _raise_on(err, "raycast_scatter", hit.shape)
    launch_counts["raycast_scatter"] += 1
    return d_sdf, d_c, d_n, d_s


def scatter_plain(g_color, g_normal, g_semantic, g_depth, hit, hit_idx, n_voxels: int):
    """Plain PyTorch version of :func:`scatter` (any device): one index_add_
    of the 22 channels into a (B, N+1) accumulator whose last row takes the
    pixels without a hit."""
    B, P = hit.shape
    dev = hit.device

    def part(g, nc):
        return torch.zeros((B, P, nc), device=dev) if g is None else g.reshape(B, P, nc).float()

    G = torch.cat([part(g_color, 3), part(g_normal, 3), part(g_semantic, NUM_CLASSES),
                   part(g_depth, 1), torch.ones((B, P, 1), device=dev)], dim=-1)
    G = torch.where(hit[..., None] & torch.isfinite(G), G, 0.0)
    idx = torch.where(hit, hit_idx.long(), n_voxels)
    rows = (torch.arange(B, device=dev)[:, None] * (n_voxels + 1) + idx).reshape(-1)
    acc = torch.zeros((B * (n_voxels + 1), N_GRAD + 1), device=dev)
    acc.index_add_(0, rows, G.reshape(-1, N_GRAD + 1))
    acc = acc.reshape(B, n_voxels + 1, N_GRAD + 1)[:, :n_voxels]
    accn = acc[..., :-1] / torch.clamp(acc[..., -1:], min=1.0)
    return (accn[..., 6 + NUM_CLASSES].contiguous(), accn[..., 0:3].contiguous(),
            accn[..., 3:6].contiguous(), accn[..., 6:6 + NUM_CLASSES].contiguous())


# ---------------------------------------------------------------------------
# K7: the occupancy march
# ---------------------------------------------------------------------------


def occ_march(occ: torch.Tensor, setup: MarchSetup, cfg: RaycastConfig,
              samples: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per ray, 1 if a lattice sample ``t0 + k * ray_increment`` (k = 0
    first, up to ``t_stop`` and at most ``cfg.max_samples``) has an occupied
    nearest voxel: (B,P) uint8. occ (B,Z,Y,X) bool. CUDA tensors go to the
    kernel (K7), CPU tensors to :func:`occ_march_plain`; the two agree on
    every pixel. On a card, int32 (B,P) ``samples`` receives per ray the
    samples taken (to measure the work; :func:`occ_march_plain` counts them
    too)."""
    if _device_kind(occ, "raycast_occ") == "cpu":
        return occ_march_plain(occ, setup, cfg)
    B, Z, Y, X = occ.shape
    P = setup.t0.shape[1]
    if P % cfg.width:
        raise ValueError(f"raycast_occ: {P} rays a row is not a multiple of width {cfg.width}")
    _check_cuda("raycast_occ", occ, *setup)
    hit = torch.empty((B, P), dtype=torch.uint8, device=occ.device)
    with torch.cuda.device(occ.device):
        err = _library().spsg_raycast_occ(
            occ.data_ptr(), setup.origin.data_ptr(), setup.direction.data_ptr(),
            setup.t0.data_ptr(), setup.t_stop.data_ptr(), hit.data_ptr(), _ptr(samples),
            B, Z, Y, X, P, cfg.width, cfg.ray_increment, cfg.max_samples, _stream(occ))
    _raise_on(err, "raycast_occ", occ.shape)
    launch_counts["raycast_occ"] += 1
    return hit


def occ_march_plain(occ, setup: MarchSetup, cfg: RaycastConfig, return_samples: bool = False):
    """Plain PyTorch version of :func:`occ_march` (any device): the JAX
    package's lockstep loop without its coarse skip (which is exact),
    ``march_block`` samples a round; it stops when no ray is left (a host read
    per round on a card). With ``return_samples`` also (B,P) int64, per ray the
    samples K7 takes: up to and including the first occupied one, or every
    sample up to ``t_stop`` and the cap."""
    B, Z, Y, X = occ.shape
    dims = (Z, Y, X)
    dev = occ.device
    flat = occ.reshape(B, -1)
    origin, direction, _, t0, t_stop = setup
    P = t0.shape[1]
    ox, oy, oz = (origin[:, None, i, None] for i in range(3))
    dx, dy, dz = (direction[..., i, None] for i in range(3))
    F_ = cfg.march_block
    hit = torch.zeros((B, P), dtype=torch.bool, device=dev)
    samples = torch.zeros((B, P), dtype=torch.int64, device=dev)
    for k0 in range(0, cfg.max_samples, F_):
        # the same float t as the kernel's: the sample index is exact
        ks = torch.arange(k0, k0 + F_, dtype=torch.float32, device=dev)
        t = t0[..., None] + ks * cfg.ray_increment
        alive = ~hit & (t[..., 0] <= t_stop)
        if not bool(alive.any()):
            break
        in_range = t <= t_stop[..., None]
        ix, iy, iz = (torch.floor(o + t * d + 0.5).to(torch.int64)
                      for o, d in ((ox, dx), (oy, dy), (oz, dz)))
        inb = (ix >= 0) & (iy >= 0) & (iz >= 0) & (ix < X) & (iy < Y) & (iz < Z)
        idx = _flat_index(ix.clamp(0, X - 1), iy.clamp(0, Y - 1), iz.clamp(0, Z - 1), dims)
        got = torch.gather(flat, 1, idx.reshape(B, -1)).reshape(idx.shape) & inb & in_range
        first = torch.argmax(got.to(torch.uint8), dim=-1)
        newly = alive & got.any(dim=-1)
        samples += torch.where(newly, first + 1, torch.where(alive, in_range.sum(dim=-1), 0))
        hit |= newly
    hit = hit.to(torch.uint8)
    return (hit, samples) if return_samples else hit


def _occ_grid(occ: torch.Tensor) -> torch.Tensor:
    if occ.dim() != 4:
        raise ValueError(f"raycast_occ: occ must be (B,Z,Y,X), got {tuple(occ.shape)}")
    return (occ if occ.dtype == torch.bool else occ != 0).contiguous()


def occ_setup(occ, view, intrinsics, cfg: RaycastConfig):
    """(occ as a contiguous bool grid, the rays of :func:`march_setup` clipped
    to the box of its occupied voxels)."""
    occ = _occ_grid(occ)
    with torch.no_grad():
        return occ, march_setup(occ, view, intrinsics, cfg)


def raycast_occ(occ, view, intrinsics, cfg: RaycastConfig) -> torch.Tensor:
    """Binary occupancy raycast (the JAX package's ``raycast_occ``; reference
    raycast_occ_cuda_kernel): 1 where a lattice sample of the pixel's ray has
    an occupied nearest voxel. occ (B,Z,Y,X) bool or uint8 (0 = empty); view
    (B,4,4) camera->grid; intrinsics (B,4). Returns (B,H,W) uint8. The rays are
    the march's (:func:`march_setup` on the occupied voxels), walked by
    :func:`occ_march` (K7 on a card)."""
    occ, setup = occ_setup(occ, view, intrinsics, cfg)
    return occ_march(occ, setup, cfg).reshape(occ.shape[0], cfg.height, cfg.width)


def raycast_occ_plain(occ, view, intrinsics, cfg: RaycastConfig) -> torch.Tensor:
    """Plain PyTorch version of :func:`raycast_occ` (any device)."""
    occ, setup = occ_setup(occ, view, intrinsics, cfg)
    return occ_march_plain(occ, setup, cfg).reshape(occ.shape[0], cfg.height, cfg.width)


# ---------------------------------------------------------------------------
# the differentiable pass
# ---------------------------------------------------------------------------


class _RaycastAttrs(torch.autograd.Function):
    """Images from hit voxels (K5) with the averaged scatter (K6) as backward.
    Inputs: sdf (B,N), color / normal (B,N,3), semantic (B,N,14) (None for
    zeros), then hit, hit_idx, depth (B,P) from the march."""

    @staticmethod
    def forward(ctx, sdf, color, normal, semantic, hit, hit_idx, depth):
        ctx.save_for_backward(hit, hit_idx)
        ctx.n_voxels = sdf.shape[1]
        # an image the loss does not use hands its cotangent over as None
        ctx.set_materialize_grads(False)
        return shade(color, normal, semantic, hit, hit_idx, depth)

    @staticmethod
    def backward(ctx, g_color, g_depth, g_normal, g_semantic):
        hit, hit_idx = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need[:4]):
            return (None,) * 7
        # autograd hands over slices of a cat, expands of a broadcast, ...
        g_color, g_depth, g_normal, g_semantic = (
            None if g is None else g.contiguous() for g in (g_color, g_depth, g_normal, g_semantic))
        d_sdf, d_c, d_n, d_s = scatter(g_color, g_normal, g_semantic, g_depth, hit, hit_idx,
                                       ctx.n_voxels)
        return (d_sdf if need[0] else None, d_c if need[1] else None,
                d_n if need[2] else None, d_s if need[3] else None, None, None, None)


def shade_hits(sdf, color, normal, semantic, hits: dict, cfg: RaycastConfig) -> RaycastOutput:
    """Differentiable attribute pass over precomputed hits
    (:func:`find_surface_crossings`). sdf (B,Z,Y,X); color / normal
    (B,Z,Y,X,3), semantic (B,Z,Y,X,14), each may be None. Gradients flow to
    sdf (through the depth image), color, normal and semantic."""
    B = sdf.shape[0]
    n = sdf[0].numel()

    def flat(a, nc):
        return None if a is None else a.reshape(B, n, nc).contiguous()

    c, d, nr, s = _RaycastAttrs.apply(
        sdf.reshape(B, n), flat(color, 3), flat(normal, 3), flat(semantic, NUM_CLASSES),
        hits["hit"].contiguous(), hits["hit_idx"].contiguous(), hits["depth"].contiguous())
    hw = (B, cfg.height, cfg.width)
    return RaycastOutput(c.reshape(hw + (3,)), d.reshape(hw), nr.reshape(hw + (3,)),
                         s.reshape(hw + (NUM_CLASSES,)))


def raycast(sdf, valid, color, normal, semantic, view, intrinsics,
            cfg: RaycastConfig) -> RaycastOutput:
    """Differentiable raycast of a dense batched TSDF.

    sdf (B,Z,Y,X) float32 in voxel units; valid (B,Z,Y,X) bool (surface voxels,
    |sdf| < truncation); color, normal (B,Z,Y,X,3) and semantic (B,Z,Y,X,14)
    or None; view (B,4,4) camera->grid; intrinsics (B,4) = [fx, fy, mx, my].
    Gradients flow to sdf (via depth), color, normal and semantic only."""
    hits = find_surface_crossings(sdf, valid, view, intrinsics, cfg)
    return shade_hits(sdf, color, normal, semantic, hits, cfg)

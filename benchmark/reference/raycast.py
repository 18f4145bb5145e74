"""Plain raycaster of the reference: a frozen copy of the plain versions in
``spsg_tpu_torch/ops/raycast.py`` (ray set-up, march, shade, the averaged
scatter as the shade's backward), in XLA's arithmetic (``xla_arith.py``).
Every function runs on any device with PyTorch operations alone."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .xla_arith import div_const, fma32, sqrt32

NEG_INF = -float("inf")
NUM_CLASSES = 14
# gradient channels of the scatter: colour 3, normal 3, semantic 14, depth 1
N_GRAD = 3 + 3 + NUM_CLASSES + 1


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
    """Euclidean norm over the last axis of size 3, as XLA's reduction forms
    it: each square added into the running sum by a fused multiply-add, the
    root correctly rounded."""
    return sqrt32(fma32(v[..., 2], v[..., 2], fma32(v[..., 1], v[..., 1], v[..., 0] * v[..., 0])))


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
    # XLA's dot: the 3-term products added into the running sum by fused
    # multiply-adds, left to right (the three rows at once)
    r = rot[:, None]  # (B, 1, 3, 3)
    c = cam_dir[..., None, :]  # (B, P, 1, 3)
    world_dir = fma32(r[..., 2], c[..., 2], fma32(r[..., 1], c[..., 1], r[..., 0] * c[..., 0]))
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


def march_setup_plain(valid, view, intrinsics, cfg: RaycastConfig) -> MarchSetup:
    """Rays, and the stretch of each that the march walks: from the box of
    valid voxels (snapped down to the lattice of ``depth_min / cam_z + k *
    ray_increment``) to its exit plus one step, within [depth_min, depth_max].
    In XLA's arithmetic: the division by the step a product with its
    reciprocal, ``t_start + skip * step`` one fused multiply-add."""
    origin, direction, cam_z = _camera_rays(view, intrinsics, cfg.width, cfg.height)
    t_start = _rdiv(cfg.depth_min, cam_z)
    t_end = _rdiv(cfg.depth_max, cam_z)
    lo, hi = _valid_bounds(valid)
    t_enter, t_exit = _ray_aabb(origin, direction, lo, hi)
    skip = torch.clamp(torch.floor(div_const(t_enter - t_start, cfg.ray_increment)), min=0.0)
    t0 = fma32(skip, cfg.ray_increment, t_start)
    t_stop = torch.minimum(t_end, t_exit + cfg.ray_increment)
    return MarchSetup(origin.contiguous(), direction.contiguous(), cam_z.contiguous(),
                      t0.contiguous(), t_stop.contiguous())



def _flat_index(ix, iy, iz, dims):
    Z, Y, X = dims
    return (iz * Y + iy) * X + ix


def _trilerp(sdf_flat, valid_flat, px, py, pz, dims):
    """Trilinear SDF at (B, ...) positions, NaN where any of the 8 corners is
    invalid (or not finite) or the cell leaves the grid; corner weights and
    their sum in the JAX package's order (w000*c0 + ... + w111*c7), the sum as
    XLA fuses it: fma(w000, c0, w001*c1), then each next product added by a
    fused multiply-add."""
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
    val = fma32(w[0], corners[0], w[1] * corners[1])
    for wk, ck in zip(w[2:], corners[2:]):
        val = fma32(wk, ck, val)
    ok = ok.reshape(px.shape) & torch.isfinite(val)
    return torch.where(ok, val, torch.nan), ok


def _positions(o, d, t):
    """``o + t d`` on each axis, one fused multiply-add each (as XLA forms
    it); t (B, ...) broadcasts against the rays' (B, P) leading axes."""
    extra = (None,) * (t.dim() - 2)
    return [fma32(t, di[(...,) + extra], oi[(...,) + extra]) for oi, di in zip(o, d)]


def march_plain(sdf, valid, setup: MarchSetup, cfg: RaycastConfig):
    """Plain PyTorch version of :func:`march` (any device): the JAX package's
    plain march, all rays in lockstep, ``march_block`` lattice samples a
    round; it stops when no ray is left (a host read per round on a card). In
    XLA's arithmetic (:mod:`.xla_arith`): the lattice ``t0 + k * step``, the
    positions ``o + t d``, the trilinear sum and the bisection's ``a + r (b -
    a)`` each a fused multiply-add."""
    _check_grid(sdf, valid)
    B, Z, Y, X = sdf.shape
    dims = (Z, Y, X)
    sdf_flat = sdf.reshape(B, -1)
    valid_flat = valid.reshape(B, -1)
    origin, direction, cam_z, t0, t_stop = setup
    P = t0.shape[1]
    o = [origin[:, None, i].expand(B, P) for i in range(3)]
    d = [direction[..., i] for i in range(3)]
    step = cfg.ray_increment

    def sample(t):
        return _trilerp(sdf_flat, valid_flat, *_positions(o, d, t), dims)

    F_ = cfg.march_block
    offs = torch.arange(F_, dtype=torch.float32, device=sdf.device)
    prev = sample(t0)[0]
    found = torch.zeros((B, P), dtype=torch.bool, device=sdf.device)
    t_lo, d_lo, t_hi, d_hi = (torch.zeros((B, P), device=sdf.device) for _ in range(4))
    k = torch.ones((B, P), device=sdf.device)  # sample 0 is prev
    for _ in range(cfg.max_samples // F_):
        t_base = fma32(k, step, t0)
        alive = ~found & (t_base <= t_stop)
        if not bool(alive.any()):
            break
        # t from the exact integer sample index: the same float t as the kernel's
        treal = fma32(k[..., None] + offs, step, t0[..., None])
        in_range = treal <= t_stop[..., None]
        dead = found | (t_base > t_stop)
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
        cmid = fma32(da / denom, b - a, a)
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
    ix, iy, iz = (torch.floor(p + 0.5).to(torch.int64) for p in _positions(o, d, alpha))
    inb = (ix >= 0) & (iy >= 0) & (iz >= 0) & (ix < X) & (iy < Y) & (iz < Z)
    idx = _flat_index(ix.clamp(0, X - 1), iy.clamp(0, Y - 1), iz.clamp(0, Z - 1), dims)
    hit = found & ok_bis & inb & torch.gather(valid_flat, 1, idx)
    return hit, alpha, alpha * cam_z, idx.to(torch.int32)

def _check_grid(sdf, valid):
    if sdf.dim() != 4 or valid.shape != sdf.shape or valid.dtype != torch.bool:
        raise ValueError(f"raycast: sdf (B,Z,Y,X) and a bool valid of its shape, got "
                         f"{tuple(sdf.shape)} / {tuple(valid.shape)} {valid.dtype}")


def find_surface_crossings(sdf, valid, view, intrinsics, cfg: RaycastConfig):
    """Non-differentiable surface search: dict of per-pixel ``hit`` (B,P)
    bool, ``alpha`` (B,P) ray length, ``depth`` (B,P) camera z and
    ``hit_idx`` (B,P) int32."""
    with torch.no_grad():
        setup = march_setup_plain(valid, view, intrinsics, cfg)
        hit, alpha, depth, hit_idx = march_plain(sdf.detach().contiguous(), valid.contiguous(),
                                                 setup, cfg)
    return dict(hit=hit, alpha=alpha, depth=depth, hit_idx=hit_idx)


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
        return shade_plain(color, normal, semantic, hit, hit_idx, depth)

    @staticmethod
    def backward(ctx, g_color, g_depth, g_normal, g_semantic):
        hit, hit_idx = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need[:4]):
            return (None,) * 7
        # autograd hands over slices of a cat, expands of a broadcast, ...
        g_color, g_depth, g_normal, g_semantic = (
            None if g is None else g.contiguous() for g in (g_color, g_depth, g_normal, g_semantic))
        d_sdf, d_c, d_n, d_s = scatter_plain(g_color, g_normal, g_semantic, g_depth, hit, hit_idx,
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

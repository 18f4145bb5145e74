"""Z-buffered triangle rasterization for the virtual scanner (the PyTorch
port's copy of ``spsg_tpu/datagen/raster.py``: host code, numpy and C++).

Matches the reference datagen's rendering fidelity
(the reference's datagen/src/Scene.cpp:169-227: D3D11 mesh rasterization,
depth converted to camera-z and range-validated, interpolated vertex
colors) instead of the point-splat approximation — splats leave
sample-density holes that the median fill then invents data for.

The hot path is a ~150-line native C++ kernel (raster_native/rasterize.cpp)
built on first use with g++ (same self-build pattern as ops/mesh.py); a
pure-numpy per-face fallback keeps small meshes working without a
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from typing import Optional, Tuple

import numpy as np

_LIB = None
_LIB_FAILED = False


def _build_native() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None:
        return _LIB
    if _LIB_FAILED:
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "raster_native", "rasterize.cpp")
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        out = os.path.join(here, "raster_native", f"librasterize-{digest}.so")
        if not os.path.isfile(out):
            # built beside its final name and moved there: processes that build
            # at once never load a half-written library
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        lib.spsg_rasterize.restype = ctypes.c_int
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.spsg_rasterize.argtypes = [
            f32p, f32p, ctypes.POINTER(ctypes.c_int32), f32p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            f32p, f32p,
        ]
        _LIB = lib
        return lib
    except Exception as e:  # pragma: no cover - toolchain failures
        warnings.warn(
            f"spsg_tpu_torch: native rasterizer build failed ({e}); falling back "
            "to the slow numpy per-face rasterizer", stacklevel=2,
        )
        _LIB_FAILED = True
        return None


def _rasterize_numpy(vc, vcol, faces, shade, fx, fy, cx, cy, W, H, zmin, zmax):
    """Per-face numpy fallback; same semantics as the native kernel."""
    depth = np.zeros((H, W), np.float32)
    color = np.zeros((H, W, 3), np.float32) if vcol is not None else None
    for f in range(len(faces)):
        tri = vc[faces[f]]
        if (tri[:, 2] < zmin).all():
            continue
        # near-plane clip (Sutherland-Hodgman on z >= zmin)
        attrs = vcol[faces[f]] if vcol is not None else np.zeros((3, 3), np.float32)
        poly = []
        for i in range(3):
            a, b = tri[i], tri[(i + 1) % 3]
            ca, cb = attrs[i], attrs[(i + 1) % 3]
            if a[2] >= zmin:
                poly.append((a, ca))
            if (a[2] >= zmin) != (b[2] >= zmin):
                t = (zmin - a[2]) / (b[2] - a[2])
                poly.append((a + t * (b - a), ca + t * (cb - ca)))
        if len(poly) < 3:
            continue
        for t in range(1, len(poly) - 1):
            q = [poly[0], poly[t], poly[t + 1]]
            iz = np.array([1.0 / p[0][2] for p in q])
            su = np.array([fx * p[0][0] / p[0][2] + cx for p in q])
            sv = np.array([fy * p[0][1] / p[0][2] + cy for p in q])
            cz = np.stack([p[1] * izk for p, izk in zip(q, iz)])
            area = (su[1] - su[0]) * (sv[2] - sv[0]) - (sv[1] - sv[0]) * (su[2] - su[0])
            if abs(area) < 1e-12:
                continue
            u0 = max(0, int(np.ceil(su.min())))
            u1 = min(W - 1, int(np.floor(su.max())))
            v0 = max(0, int(np.ceil(sv.min())))
            v1 = min(H - 1, int(np.floor(sv.max())))
            if u0 > u1 or v0 > v1:
                continue
            px, py = np.meshgrid(np.arange(u0, u1 + 1), np.arange(v0, v1 + 1))
            w0 = ((su[1] - px) * (sv[2] - py) - (sv[1] - py) * (su[2] - px)) / area
            w1 = ((su[2] - px) * (sv[0] - py) - (sv[2] - py) * (su[0] - px)) / area
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            invz = w0 * iz[0] + w1 * iz[1] + w2 * iz[2]
            inside &= invz > 0
            with np.errstate(divide="ignore"):
                z = np.where(invz > 0, 1.0 / np.maximum(invz, 1e-30), np.inf)
            inside &= z <= zmax
            cur = depth[py, px]
            win = inside & ((cur == 0) | (z < cur))
            depth[py[win], px[win]] = z[win].astype(np.float32)
            if color is not None:
                interp = (
                    w0[..., None] * cz[0] + w1[..., None] * cz[1] + w2[..., None] * cz[2]
                ) * z[..., None] * shade[f]
                color[py[win], px[win]] = interp[win].astype(np.float32)
    return depth, color


def rasterize_depth(
    verts: np.ndarray,                 # (NV, 3) world
    faces: np.ndarray,                 # (NF, 3) int
    vert_colors: Optional[np.ndarray],  # (NV, 3) uint8 or None
    cam2world: np.ndarray,             # (4, 4)
    fx: float, fy: float, cx: float, cy: float,
    width: int, height: int,
    depth_min: float, depth_max: float,
    face_shade: Optional[np.ndarray] = None,  # (NF,) lighting multiplier
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Render one frame. Returns (depth (H,W) float32 meters with 0 holes,
    color (H,W,3) uint8 or None)."""
    world2cam = np.linalg.inv(cam2world)
    vc = (verts @ world2cam[:3, :3].T + world2cam[:3, 3]).astype(np.float32)
    vcol = (
        np.ascontiguousarray(vert_colors, np.float32)
        if vert_colors is not None
        else None
    )
    faces32 = np.ascontiguousarray(faces, np.int32)
    shade = (
        np.ascontiguousarray(face_shade, np.float32)
        if face_shade is not None
        else None
    )

    lib = _build_native()
    if lib is not None:
        depth = np.zeros((height, width), np.float32)
        color = np.zeros((height, width, 3), np.float32) if vcol is not None else None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.spsg_rasterize(
            vc.ctypes.data_as(f32p),
            vcol.ctypes.data_as(f32p) if vcol is not None else None,
            faces32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            shade.ctypes.data_as(f32p) if shade is not None else None,
            len(vc), len(faces32),
            fx, fy, cx, cy, width, height, depth_min, depth_max,
            depth.ctypes.data_as(f32p),
            color.ctypes.data_as(f32p) if color is not None else None,
        )
    else:
        if shade is None:
            shade = np.ones(len(faces32), np.float32)
        depth, color = _rasterize_numpy(
            vc, vcol, faces32, shade, fx, fy, cx, cy, width, height,
            depth_min, depth_max,
        )
    out_color = None
    if color is not None:
        out_color = np.clip(np.round(color), 0, 255).astype(np.uint8)
    return depth, out_color

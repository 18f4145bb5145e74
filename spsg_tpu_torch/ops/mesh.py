"""Mesh extraction + mesh I/O (replacement for the reference's C++
marching-cubes extension, torch/utils/marching_cubes/, and its plyfile-based
I/O, data_util.py:301-327).

``marching_cubes`` extracts the TSDF isosurface via a native C++ extractor
(built on first use with g++; welded vertices, trilinear per-vertex colors)
with a pure-numpy fallback. Two topologies: ``method="mc"`` (default) is
classic marching cubes — vertices only on cube edges, the reference's vertex
set (marching_cubes.cpp:156-581), realized table-free by per-cube polygon
tracing with the asymptotic decider on ambiguous faces (crack-free by
construction); ``method="tet"`` is marching tetrahedra (watertight, extra
diagonal vertices). PLY (binary little-endian) and OBJ writers are
self-contained."""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
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
    src = os.path.join(here, "mesh_native", "mesh_extract.cpp")
    try:
        # name the binary by the source content hash: a fresh checkout (which
        # resets mtimes) or a stale/wrong-arch leftover can never shadow a
        # changed source — the hash misses and we rebuild
        with open(src, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        out = os.path.join(here, "mesh_native", f"libmesh_extract-{digest}.so")
        if not os.path.isfile(out):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", out],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(out)
        lib.spsg_extract_isosurface.restype = ctypes.c_int
        lib.spsg_extract_isosurface.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.spsg_mesh_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib
    except Exception as e:  # pragma: no cover - toolchain issues
        print(f"mesh_extract: native build failed ({e}); using numpy fallback")
        _LIB_FAILED = True
        return None


def marching_cubes(
    sdf: np.ndarray,
    colors: Optional[np.ndarray] = None,
    isovalue: float = 0.0,
    truncation: float = 3.0,
    method: str = "mc",
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Extract the isosurface of a dense (Z, Y, X) TSDF.

    Returns (verts (N,3) float32 in xyz grid coords, colors (N,3) uint8 or
    None, faces (M,3) int64). Cubes touching unobserved (non-finite or
    |sdf| >= truncation) voxels are skipped (reference marching_cubes.cpp
    weight rule :72-105). ``method``: "mc" = classic marching-cubes topology
    (reference-comparable vertex set), "tet" = marching tetrahedra."""
    sdf = np.ascontiguousarray(np.asarray(sdf, np.float32))
    dimz, dimy, dimx = sdf.shape
    cptr = None
    if colors is not None:
        colors = np.ascontiguousarray(np.asarray(colors, np.uint8))
        assert colors.shape == (dimz, dimy, dimx, 3)
        cptr = colors.ctypes.data_as(ctypes.c_void_p)

    lib = _build_native()
    if lib is not None:
        vp = ctypes.POINTER(ctypes.c_float)()
        cp = ctypes.POINTER(ctypes.c_uint8)()
        fp = ctypes.POINTER(ctypes.c_int64)()
        nv = ctypes.c_int64()
        nf = ctypes.c_int64()
        ret = lib.spsg_extract_isosurface(
            sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cptr,
            dimz,
            dimy,
            dimx,
            isovalue,
            truncation,
            {"mc": 0, "tet": 1}[method],
            ctypes.byref(vp),
            ctypes.byref(cp),
            ctypes.byref(fp),
            ctypes.byref(nv),
            ctypes.byref(nf),
        )
        assert ret == 0
        n_verts = nv.value
        n_faces = nf.value
        verts = np.ctypeslib.as_array(vp, shape=(n_verts, 3)).copy() if n_verts else np.zeros((0, 3), np.float32)
        out_colors = None
        if colors is not None and n_verts:
            out_colors = np.ctypeslib.as_array(cp, shape=(n_verts, 3)).copy()
        elif colors is not None:
            out_colors = np.zeros((0, 3), np.uint8)
        faces = np.ctypeslib.as_array(fp, shape=(n_faces, 3)).copy() if n_faces else np.zeros((0, 3), np.int64)
        lib.spsg_mesh_free(vp)
        if cptr is not None:
            lib.spsg_mesh_free(cp)
        lib.spsg_mesh_free(fp)
        return verts.astype(np.float32), out_colors, faces
    # the fallback is a faceless point soup: callers relying on method='mc'
    # topology guarantees (watertight closed surfaces) must see the
    # capability downgrade, not silently get zero faces
    import warnings

    warnings.warn(
        "spsg_tpu_torch: native mesh extractor unavailable (no g++/.so) — falling "
        f"back to a degenerate point-soup mesh; method={method!r} topology "
        "guarantees do NOT hold",
        stacklevel=2,
    )
    return _marching_tetrahedra_np(sdf, colors, isovalue, truncation)


# pure-numpy fallback: surface point soup as degenerate micro-triangles
def _marching_tetrahedra_np(sdf, colors, isovalue, truncation):
    valid = np.isfinite(sdf) & (np.abs(sdf) < truncation)
    surf = valid & (np.abs(sdf - isovalue) < 1.0)
    locs = np.argwhere(surf)
    verts = locs[:, ::-1].astype(np.float32)  # zyx -> xyz
    out_colors = None
    if colors is not None:
        out_colors = colors[locs[:, 0], locs[:, 1], locs[:, 2]]
    faces = np.zeros((0, 3), np.int64)
    return verts, out_colors, faces


# ---------------------------------------------------------------------------
# mesh / point I/O
# ---------------------------------------------------------------------------


def save_ply(
    path: str,
    verts: np.ndarray,
    faces: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    transform: Optional[np.ndarray] = None,
) -> None:
    """Binary little-endian PLY writer (replaces plyfile; reference
    marching_cubes.cpp save_to_ply :519-560)."""
    verts = np.asarray(verts, np.float32)
    if transform is not None:
        h = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], 1)
        h = h @ np.asarray(transform, np.float32).T
        verts = h[:, :3] / np.maximum(np.abs(h[:, 3:4]), 1e-12) * np.sign(h[:, 3:4])
    n = len(verts)
    m = 0 if faces is None else len(faces)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        hdr += ["property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += [
                "property uchar red",
                "property uchar green",
                "property uchar blue",
            ]
        hdr += [f"element face {m}", "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is not None:
            colors = np.asarray(colors, np.uint8)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = verts
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        if m:
            faces = np.asarray(faces, np.int32)
            rec = np.zeros(m, dtype=[("n", "u1"), ("idx", "<i4", 3)])
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())


def load_ply(path: str):
    """Minimal binary/ascii PLY reader for our own files + reference meshes.
    Returns (verts, colors_or_None, faces)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts = 0
        n_faces = 0
        props = []
        binary = any("binary_little_endian" in l for l in header)
        elem = None
        for l in header:
            t = l.split()
            if t[0] == "element":
                elem = t[1]
                if elem == "vertex":
                    n_verts = int(t[2])
                elif elem == "face":
                    n_faces = int(t[2])
            elif t[0] == "property" and elem == "vertex" and t[1] != "list":
                props.append((t[2], t[1]))
        tmap = {"float": "<f4", "float32": "<f4", "uchar": "u1", "uint8": "u1",
                "int": "<i4", "double": "<f8"}
        dt = np.dtype([(name, tmap[t]) for name, t in props])
        if binary:
            vdata = np.frombuffer(f.read(n_verts * dt.itemsize), dtype=dt)
            verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], 1).astype(np.float32)
            colors = None
            if "red" in dt.names:
                colors = np.stack([vdata["red"], vdata["green"], vdata["blue"]], 1)
            faces = []
            for _ in range(n_faces):
                cnt = struct.unpack("B", f.read(1))[0]
                faces.append(struct.unpack(f"<{cnt}i", f.read(4 * cnt)))
            faces = np.asarray(faces, np.int64) if faces else np.zeros((0, 3), np.int64)
            return verts, colors, faces
        raise ValueError("ascii ply not supported")


def save_obj(path: str, verts: np.ndarray, faces: Optional[np.ndarray] = None,
             colors: Optional[np.ndarray] = None) -> None:
    """OBJ writer with optional per-vertex colors (reference
    marching_cubes.py save_mesh :9-26, data_util.py:311-320)."""
    with open(path, "w") as f:
        for i, v in enumerate(np.asarray(verts)):
            if colors is not None:
                c = np.asarray(colors[i], np.float32) / 255.0
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for t in np.asarray(faces):
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def sample_point_cloud(
    verts: np.ndarray, faces: np.ndarray, num_points: int, seed: int = 0
) -> np.ndarray:
    """Area-uniform barycentric surface sampling (reference
    sample_util.py:5-42)."""
    rng = np.random.default_rng(seed)
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    if areas.sum() <= 0:
        idx = rng.integers(0, len(verts), num_points)
        return verts[idx]
    probs = areas / areas.sum()
    fidx = rng.choice(len(faces), size=num_points, p=probs)
    r1 = np.sqrt(rng.random(num_points))
    r2 = rng.random(num_points)
    a = 1.0 - r1
    b = r1 * (1.0 - r2)
    c = r1 * r2
    return (
        a[:, None] * v0[fidx] + b[:, None] * v1[fidx] + c[:, None] * v2[fidx]
    ).astype(np.float32)

"""Binary voxel-grid file formats of the SPSG dataset.

Formats (byte-compatible with the reference implementation):

``.sdf`` (sparse TSDF chunk / scene file; reference torch/data_util.py:64-159
and datagen VoxelGrid.h:125-184):
    dimx, dimy, dimz         : 3 x uint64 (note: x first)
    voxelsize                : float32 (meters)
    world2grid               : 16 x float32, row-major 4x4
    num                      : uint64
    locs                     : num x 3 uint32, **xyz** order (flipped to zyx on load)
    sdf                      : num x float32, in meters (divided by voxelsize on load)
  Chunk files (``__inc__``/``__cmp__``) additionally append:
    num_known                : uint64 (== dimx*dimy*dimz)
    known                    : num_known x uint8, dense zyx
    num_color                : uint64 (== dimx*dimy*dimz)
    colors                   : num_color x 3 uint8, dense zyx
  ``__sem__`` chunk files (produced by the extend_sdfs tool,
  reference torch/extend_sdfs.py:133-155) further append:
    num_semantic             : uint64 (== dimx*dimy*dimz)
    semantics                : num_semantic x uint8, dense zyx

``.colors`` (scene color file; reference torch/data_util.py:113-127):
    dimx, dimy, dimz         : 3 x uint64
    num                      : uint64 (sparse, paired with the .sdf locs)
    colors                   : num x 3 uint8

``.knw`` (known-space file; reference torch/data_util.py:163-184,
datagen VoxelGrid.h:321-340): encoding {0: known-empty, 1: known-occupied,
>=2: unknown-by-distance}:
    dimx, dimy, dimz         : 3 x uint64
    voxelsize                : float32
    world2grid               : 16 x float32
    known                    : dimz*dimy*dimx x uint8, dense zyx

``.semantics`` (standalone scene semantics; reference
torch/extend_sdfs_2cm.py:100-105):
    dimx, dimy, dimz         : 3 x uint64
    semantics                : dimz*dimy*dimx x uint8, dense zyx
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np

_U64 = "<Q"
_F32 = "<f"


@dataclasses.dataclass
class SdfData:
    """Contents of one .sdf file (locs in zyx order, sdf in voxel units)."""

    dims: Tuple[int, int, int]  # (dimz, dimy, dimx)
    voxelsize: float
    world2grid: np.ndarray  # (4, 4) float32
    locs: np.ndarray  # (N, 3) int32, zyx
    sdf: np.ndarray  # (N,) float32, voxel units
    known: Optional[np.ndarray] = None  # (dimz, dimy, dimx) uint8
    colors: Optional[np.ndarray] = None  # (dimz, dimy, dimx, 3) uint8 dense
    semantics: Optional[np.ndarray] = None  # (dimz, dimy, dimx) uint8 dense


def sparse_to_dense(locs: np.ndarray, values: np.ndarray, dims_zyx, default_val):
    """Scatter sparse (zyx loc, value) pairs into a dense zyx grid.

    Mirrors reference torch/data_util.py:47-54 (sparse_to_dense_np).
    """
    dimz, dimy, dimx = dims_zyx
    nf = 1 if values.ndim == 1 else values.shape[1]
    dense = np.full((dimz, dimy, dimx, nf), default_val, dtype=values.dtype)
    dense[locs[:, 0], locs[:, 1], locs[:, 2], :] = values.reshape(-1, nf)
    if nf == 1:
        return dense.reshape(dimz, dimy, dimx)
    return dense


def dense_to_sparse(grid: np.ndarray, thresh: float):
    """Inverse of :func:`sparse_to_dense` for |grid| < thresh voxels
    (reference torch/data_util.py:57-61)."""
    locs = np.argwhere(np.abs(grid) < thresh)
    values = grid[locs[:, 0], locs[:, 1], locs[:, 2]]
    return locs.astype(np.int32), values


def _read_header(f):
    dimx = struct.unpack(_U64, f.read(8))[0]
    dimy = struct.unpack(_U64, f.read(8))[0]
    dimz = struct.unpack(_U64, f.read(8))[0]
    voxelsize = struct.unpack(_F32, f.read(4))[0]
    world2grid = np.frombuffer(f.read(64), dtype="<f4").reshape(4, 4).copy()
    return dimx, dimy, dimz, voxelsize, world2grid


def load_sdf(
    path: str,
    load_known: bool = False,
    load_color: bool = False,
    load_semantic: bool = False,
    color_path: Optional[str] = None,
    semantic_path: Optional[str] = None,
) -> SdfData:
    """Read a sparse .sdf file (reference torch/data_util.py:64-159).

    ``color_path``/``semantic_path`` point at sidecar ``.colors``/``.semantics``
    files for full scenes; chunk files carry known+color (+semantics) inline.
    """
    with open(path, "rb") as f:
        dimx, dimy, dimz, voxelsize, world2grid = _read_header(f)
        num = struct.unpack(_U64, f.read(8))[0]
        locs = np.frombuffer(f.read(num * 12), dtype="<u4").reshape(num, 3)
        locs = np.ascontiguousarray(locs[:, ::-1]).astype(np.int32)  # xyz -> zyx
        sdf = np.frombuffer(f.read(num * 4), dtype="<f4").copy()
        sdf /= voxelsize  # meters -> voxel units (reference data_util.py:88)

        known = None
        colors = None
        semantics = None
        n_dense = dimx * dimy * dimz
        # chunk files: inline known then colors (then semantics for __sem__)
        inline = load_color and color_path is None
        if inline or load_known:
            raw = f.read(8)
            if len(raw) == 8:
                num_known = struct.unpack(_U64, raw)[0]
                assert num_known == n_dense, (num_known, n_dense)
                known_raw = np.frombuffer(f.read(num_known), dtype=np.uint8)
                if load_known:
                    known = known_raw.reshape(dimz, dimy, dimx).copy()
                    # surface voxels observed in the scan are known-occupied;
                    # voxels in front of surface are known-empty
                    # (reference data_util.py:105-108)
                    m = (sdf >= -1) & (sdf <= 1)
                    known[locs[m, 0], locs[m, 1], locs[m, 2]] = 1
                    m = sdf > 1
                    known[locs[m, 0], locs[m, 1], locs[m, 2]] = 0
        if load_color:
            if color_path is not None:
                with open(color_path, "rb") as cf:
                    cdimx = struct.unpack(_U64, cf.read(8))[0]
                    cdimy = struct.unpack(_U64, cf.read(8))[0]
                    cdimz = struct.unpack(_U64, cf.read(8))[0]
                    assert (cdimx, cdimy, cdimz) == (dimx, dimy, dimz)
                    cnum = struct.unpack(_U64, cf.read(8))[0]
                    cvals = np.frombuffer(cf.read(cnum * 3), dtype=np.uint8).reshape(cnum, 3)
                    colors = sparse_to_dense(locs, cvals, (dimz, dimy, dimx), 0)
            else:
                num_color = struct.unpack(_U64, f.read(8))[0]
                assert num_color == n_dense
                colors = (
                    np.frombuffer(f.read(num_color * 3), dtype=np.uint8)
                    .reshape(dimz, dimy, dimx, 3)
                    .copy()
                )
        if load_semantic:
            if semantic_path is not None:
                semantics = load_semantics(semantic_path, expect_dims=(dimz, dimy, dimx))
            else:
                num_sem = struct.unpack(_U64, f.read(8))[0]
                assert num_sem == n_dense
                semantics = (
                    np.frombuffer(f.read(num_sem), dtype=np.uint8)
                    .reshape(dimz, dimy, dimx)
                    .copy()
                )

    return SdfData(
        dims=(dimz, dimy, dimx),
        voxelsize=voxelsize,
        world2grid=world2grid,
        locs=locs,
        sdf=sdf,
        known=known,
        colors=colors,
        semantics=semantics,
    )


def save_sdf(
    path: str,
    dims_zyx: Tuple[int, int, int],
    voxelsize: float,
    world2grid: np.ndarray,
    locs_zyx: np.ndarray,
    sdf_voxel_units: np.ndarray,
    known: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    semantics: Optional[np.ndarray] = None,
) -> None:
    """Write a .sdf file (inverse of :func:`load_sdf`; format from datagen
    VoxelGrid.h:125-184). ``known``/``colors``/``semantics`` are dense zyx
    grids appended chunk-file style."""
    dimz, dimy, dimx = dims_zyx
    with open(path, "wb") as f:
        f.write(struct.pack(_U64, dimx))
        f.write(struct.pack(_U64, dimy))
        f.write(struct.pack(_U64, dimz))
        f.write(struct.pack(_F32, voxelsize))
        f.write(np.asarray(world2grid, dtype="<f4").reshape(16).tobytes())
        num = len(locs_zyx)
        f.write(struct.pack(_U64, num))
        locs_xyz = np.ascontiguousarray(np.asarray(locs_zyx)[:, ::-1]).astype("<u4")
        f.write(locs_xyz.tobytes())
        f.write((np.asarray(sdf_voxel_units, dtype="<f4") * voxelsize).tobytes())
        if known is not None:
            f.write(struct.pack(_U64, dimx * dimy * dimz))
            f.write(np.asarray(known, dtype=np.uint8).reshape(-1).tobytes())
        if colors is not None:
            f.write(struct.pack(_U64, dimx * dimy * dimz))
            f.write(np.asarray(colors, dtype=np.uint8).reshape(-1).tobytes())
        if semantics is not None:
            f.write(struct.pack(_U64, dimx * dimy * dimz))
            f.write(np.asarray(semantics, dtype=np.uint8).reshape(-1).tobytes())


def load_known(path: str) -> Tuple[np.ndarray, float, np.ndarray]:
    """Read a .knw file -> (known zyx uint8, voxelsize, world2grid)
    (reference torch/data_util.py:163-174)."""
    with open(path, "rb") as f:
        dimx, dimy, dimz, voxelsize, world2grid = _read_header(f)
        known = (
            np.frombuffer(f.read(dimz * dimy * dimx), dtype=np.uint8)
            .reshape(dimz, dimy, dimx)
            .copy()
        )
    return known, voxelsize, world2grid


def save_known(path: str, known: np.ndarray, voxelsize: float, world2grid: np.ndarray) -> None:
    dimz, dimy, dimx = known.shape
    with open(path, "wb") as f:
        f.write(struct.pack(_U64, dimx))
        f.write(struct.pack(_U64, dimy))
        f.write(struct.pack(_U64, dimz))
        f.write(struct.pack(_F32, voxelsize))
        f.write(np.asarray(world2grid, dtype="<f4").reshape(16).tobytes())
        f.write(np.asarray(known, dtype=np.uint8).reshape(-1).tobytes())


def rescale_known(known, pad_known, pad_scan, scale_to_dims) -> np.ndarray:
    """Upsample a half-resolution .knw grid to scan resolution
    (reference torch/data_util.py:175-184)."""
    if tuple(known.shape) == tuple(scale_to_dims):
        return known
    scale = int(round(float(scale_to_dims[2] - 2 * pad_scan[2]) / float(known.shape[2] - 2 * pad_known[2])))
    pad_offset = np.array(pad_known, dtype=np.int32) * scale - np.array(pad_scan, dtype=np.int32)
    known = known.repeat(2, 0).repeat(2, 1).repeat(2, 2)
    known = known[pad_offset[0]:, pad_offset[1]:, pad_offset[2]:]
    known = known[: scale_to_dims[0], : scale_to_dims[1], : scale_to_dims[2]]
    return known


def load_semantics(path: str, expect_dims=None) -> np.ndarray:
    """Read a .semantics file (reference torch/data_util.py:136-145)."""
    with open(path, "rb") as f:
        dimx = struct.unpack(_U64, f.read(8))[0]
        dimy = struct.unpack(_U64, f.read(8))[0]
        dimz = struct.unpack(_U64, f.read(8))[0]
        if expect_dims is not None:
            assert (dimz, dimy, dimx) == tuple(expect_dims)
        sem = (
            np.frombuffer(f.read(dimz * dimy * dimx), dtype=np.uint8)
            .reshape(dimz, dimy, dimx)
            .copy()
        )
    return sem


def save_semantics(path: str, semantics: np.ndarray) -> None:
    """Write a .semantics file (reference torch/extend_sdfs_2cm.py:100-105)."""
    dimz, dimy, dimx = semantics.shape
    with open(path, "wb") as f:
        f.write(struct.pack(_U64, dimx))
        f.write(struct.pack(_U64, dimy))
        f.write(struct.pack(_U64, dimz))
        f.write(np.asarray(semantics, dtype=np.uint8).reshape(-1).tobytes())


def save_colors_sparse(path: str, dims_zyx, colors_sparse: np.ndarray) -> None:
    """Write a sparse scene .colors file (values paired with the .sdf locs;
    format from datagen VoxelGrid.h:169-183)."""
    dimz, dimy, dimx = dims_zyx
    with open(path, "wb") as f:
        f.write(struct.pack(_U64, dimx))
        f.write(struct.pack(_U64, dimy))
        f.write(struct.pack(_U64, dimz))
        f.write(struct.pack(_U64, len(colors_sparse)))
        f.write(np.asarray(colors_sparse, dtype=np.uint8).reshape(-1).tobytes())


def preprocess_sdf(sdf: np.ndarray, truncation: float) -> np.ndarray:
    """Clamp an SDF grid to +-truncation (+-inf sentinels included;
    reference torch/data_util.py:187-190)."""
    return np.clip(sdf, -truncation, truncation)

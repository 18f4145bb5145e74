""".sens RGB-D stream reader (ScanNet/Matterport SensorData format); the
PyTorch counterpart of ``spsg_tpu/datagen/sens.py``, fusing on ``device``.

The reference datagen consumes Matterport trajectories through mLib's sensor
loaders (datagen/src/ScansDirectory.h:30-64); this is the equivalent input
path for raw `.sens` captures. Format (SensorData v4):

    version u32 (=4), strlen u64, sensor_name bytes,
    intrinsic_color 16 f32, extrinsic_color 16 f32,
    intrinsic_depth 16 f32, extrinsic_depth 16 f32,
    color_compression u32, depth_compression u32,
    color_width u32, color_height u32, depth_width u32, depth_height u32,
    depth_shift f32, num_frames u64,
    per frame: camera_to_world 16 f32, timestamp_color u64,
               timestamp_depth u64, color_bytes u64, depth_bytes u64,
               color blob (jpeg/png), depth blob (zlib-compressed u16)
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

COLOR_COMPRESSION = {0: "raw", 1: "png", 2: "jpeg"}
DEPTH_COMPRESSION = {0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}


class SensReader:
    """Streaming reader over a .sens file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        f = self._f
        self.version = struct.unpack("<I", f.read(4))[0]
        strlen = struct.unpack("<Q", f.read(8))[0]
        self.sensor_name = f.read(strlen).decode("ascii", "replace")
        self.intrinsic_color = np.frombuffer(f.read(64), "<f4").reshape(4, 4).copy()
        self.extrinsic_color = np.frombuffer(f.read(64), "<f4").reshape(4, 4).copy()
        self.intrinsic_depth = np.frombuffer(f.read(64), "<f4").reshape(4, 4).copy()
        self.extrinsic_depth = np.frombuffer(f.read(64), "<f4").reshape(4, 4).copy()
        self.color_compression = COLOR_COMPRESSION.get(
            struct.unpack("<i", f.read(4))[0], "unknown"
        )
        self.depth_compression = DEPTH_COMPRESSION.get(
            struct.unpack("<i", f.read(4))[0], "unknown"
        )
        self.color_width = struct.unpack("<I", f.read(4))[0]
        self.color_height = struct.unpack("<I", f.read(4))[0]
        self.depth_width = struct.unpack("<I", f.read(4))[0]
        self.depth_height = struct.unpack("<I", f.read(4))[0]
        self.depth_shift = struct.unpack("<f", f.read(4))[0]
        self.num_frames = struct.unpack("<Q", f.read(8))[0]

    @property
    def depth_intrinsics_params(self) -> np.ndarray:
        """(fx, fy, mx, my) for the raycaster/fusion."""
        m = self.intrinsic_depth
        return np.array([m[0, 0], m[1, 1], m[0, 2], m[1, 2]], np.float32)

    def frames(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
        """Yields (depth (H,W) float32 meters, color (H,W,3) uint8 or None,
        cam2world (4,4)) for every frame."""
        f = self._f
        for _ in range(self.num_frames):
            cam2world = np.frombuffer(f.read(64), "<f4").reshape(4, 4).copy()
            _ts_c, _ts_d = struct.unpack("<QQ", f.read(16))
            n_color = struct.unpack("<Q", f.read(8))[0]
            n_depth = struct.unpack("<Q", f.read(8))[0]
            color_blob = f.read(n_color)
            depth_blob = f.read(n_depth)
            color = self._decode_color(color_blob)
            depth = self._decode_depth(depth_blob)
            yield depth, color, cam2world

    def _decode_color(self, blob: bytes) -> Optional[np.ndarray]:
        if not blob:
            return None
        if self.color_compression in ("jpeg", "png"):
            from PIL import Image

            return np.array(Image.open(io.BytesIO(blob)).convert("RGB"))
        return np.frombuffer(blob, np.uint8).reshape(
            self.color_height, self.color_width, 3
        )

    def _decode_depth(self, blob: bytes) -> np.ndarray:
        if self.depth_compression == "zlib_ushort":
            raw = zlib.decompress(blob)
        else:
            raw = blob
        d = np.frombuffer(raw, "<u2").reshape(self.depth_height, self.depth_width)
        return d.astype(np.float32) / max(self.depth_shift, 1.0)

    def close(self):
        self._f.close()


def write_sens(
    path: str,
    depths: np.ndarray,  # (N, H, W) meters
    colors: Optional[np.ndarray],  # (N, H, W, 3) uint8 or None
    poses: np.ndarray,  # (N, 4, 4) cam2world
    intrinsic_depth: np.ndarray,  # (4, 4)
    depth_shift: float = 1000.0,
    sensor_name: str = "spsg_tpu_synthetic",
):
    """Minimal .sens writer (raw color, zlib depth) — lets the test suite and
    synthetic pipelines produce real .sens inputs."""
    n, h, w = depths.shape
    ch = colors.shape[1] if colors is not None else h
    cw = colors.shape[2] if colors is not None else w
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 4))
        name = sensor_name.encode()
        f.write(struct.pack("<Q", len(name)))
        f.write(name)
        eye = np.eye(4, dtype="<f4")
        intr = np.asarray(intrinsic_depth, "<f4")
        f.write(intr.tobytes())  # intrinsic_color
        f.write(eye.tobytes())
        f.write(intr.tobytes())  # intrinsic_depth
        f.write(eye.tobytes())
        f.write(struct.pack("<i", 0))  # raw color
        f.write(struct.pack("<i", 1))  # zlib depth
        f.write(struct.pack("<IIII", cw, ch, w, h))
        f.write(struct.pack("<f", depth_shift))
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(np.asarray(poses[i], "<f4").tobytes())
            f.write(struct.pack("<QQ", i, i))
            cblob = b"" if colors is None else np.ascontiguousarray(colors[i]).tobytes()
            dblob = zlib.compress(
                (depths[i] * depth_shift).astype("<u2").tobytes()
            )
            f.write(struct.pack("<Q", len(cblob)))
            f.write(struct.pack("<Q", len(dblob)))
            f.write(cblob)
            f.write(dblob)


def fuse_sens(
    sens_path: str,
    output_prefix: str,
    voxelsize: float = 0.02,
    frame_skip: int = 1,
    max_frames: int = 0,
    device="cuda",
):
    """Fuse a .sens stream into scene .sdf/.colors/.knw files (the raw-data
    path of the reference datagen pipeline), the grid on ``device``."""
    from . import fusion

    reader = SensReader(sens_path)
    # first pass: world bounds from unprojected depth extents
    frames = []
    for i, (depth, color, pose) in enumerate(reader.frames()):
        if i % frame_skip:
            continue
        frames.append((depth, color, pose))
        if max_frames and len(frames) >= max_frames:
            break
    reader.close()
    intr = reader.depth_intrinsics_params
    pts_min = np.full(3, np.inf)
    pts_max = np.full(3, -np.inf)
    for depth, _, pose in frames:
        h, w = depth.shape
        ys, xs = np.mgrid[0:h:8, 0:w:8]
        d = depth[ys, xs]
        ok = (d > 0.4) & (d < 4.0)
        if not ok.any():
            continue
        x = (xs[ok] - intr[2]) / intr[0] * d[ok]
        y = (ys[ok] - intr[3]) / intr[1] * d[ok]
        p = np.stack([x, y, d[ok]], 1) @ pose[:3, :3].T + pose[:3, 3]
        pts_min = np.minimum(pts_min, p.min(0))
        pts_max = np.maximum(pts_max, p.max(0))
    cfg = fusion.FusionConfig(voxelsize=voxelsize)
    dims, world2grid = fusion.grid_from_bounds(pts_min, pts_max, cfg)
    grid = fusion.fuse_frames(
        dims,
        world2grid,
        (
            (d, c.astype(np.float32) if c is not None else None, intr, p)
            for d, c, p in frames
        ),
        cfg,
        device,
    )
    fusion.save_grid(output_prefix, grid, world2grid, cfg)
    return dims, world2grid

"""Host-side data pipeline: chunk assembly, batching, file-list datasets.

Redesign of the reference DataLoader stack
(torch/scene_dataloader.py:15-265, torch/data_util.py:20-38): pure-numpy
sample assembly feeding dense channel-last batches, a thread-prefetched
iterator instead of torch DataLoader workers, and every tensor laid out so the
train step consumes it without reshapes.

Batch layout (all zyx, channel-last):
  input            (B, Z, Y, X, 4)  float32  [tsdf, 3 x color in [0,1]]
  mask             (B, Z, Y, X, 1)  float32
  target_sdf       (B, Z, Y, X)     float32  (-inf = unobserved)
  target_colors    (B, Z, Y, X, 3)  float32  in [0, 255]
  semantics        (B, Z, Y, X)     uint8    (14 = unlabeled)
  known            (B, Z, Y, X)     uint8
  world2grid       (B, 4, 4)        float32
  images_depth     (B, H, W)        float32  meters (0 = hole)     [optional]
  images_color     (B, 3, H, W)     float32                        [optional]
  images_view      (B, 4, 4)        float32  camera->grid          [optional]
  images_intrinsic (B, 4)           float32  [fx, fy, mx, my]      [optional]
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import colorspace, formats


# ---------------------------------------------------------------------------
# file lists (reference torch/data_util.py:20-38)
# ---------------------------------------------------------------------------


def get_train_files(data_path: str, file_list: str, val_file_list: str = "", max_num: int = 0):
    """Resolve train/val chunk file lists; names without '.sdf' get
    '__0__.sdf' appended (reference data_util.py:26-38). Returns
    (train_files, val_files, overfit_flag)."""
    names = open(file_list).read().splitlines()
    if names and not names[0].endswith(".sdf"):
        names = [n + "__0__.sdf" for n in names]
    files = [os.path.join(data_path, f) for f in names]
    val_files: List[str] = []
    if val_file_list:
        val_names = open(val_file_list).read().splitlines()
        val_files = [os.path.join(data_path, f) for f in val_names]
    if max_num > 0:
        files = files[:max_num]
        val_files = val_files[:max_num]
    return files, val_files, len(files) == 1


# ---------------------------------------------------------------------------
# sample assembly (reference torch/scene_dataloader.py:194-264)
# ---------------------------------------------------------------------------


def assemble_sample(
    sdf_input: np.ndarray,
    sdf_target: np.ndarray,
    input_colors: np.ndarray,
    target_colors: np.ndarray,
    semantics: Optional[np.ndarray],
    known: Optional[np.ndarray],
    world2grid: np.ndarray,
    truncation: float,
    color_space: str = "lab",
    augment_hue_scale: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """Turn raw dense grids into one training sample.

    Mirrors the tail of SceneDataset.__getitem__
    (scene_dataloader.py:194-264): hue augmentation, color-space encoding,
    input-mask computation, truncation clamping."""
    if augment_hue_scale is not None:
        input_colors = colorspace.augment_hue_np(input_colors, augment_hue_scale)
        target_colors = colorspace.augment_hue_np(target_colors, augment_hue_scale)

    if color_space == "lab":
        # target colors encoded to [0, 255]-scaled lab01; input to [0,1] lab01
        # (reference scene_dataloader.py:222-231)
        tgt01 = colorspace.rgb_to_lab01(target_colors.astype(np.float32) / 255.0)
        target_colors_f = (tgt01 * 255.0).astype(np.float32)
        input_colors_f = colorspace.rgb_to_lab01(input_colors.astype(np.float32) / 255.0)
    else:
        target_colors_f = target_colors.astype(np.float32)
        input_colors_f = input_colors.astype(np.float32) / 255.0

    # reference scene_dataloader.py:242-253: -inf counts as empty, the mask
    # marks observed-behind-surface voxels (input <= -1 within truncation)
    with np.errstate(invalid="ignore"):
        empty = np.abs(sdf_input) > truncation
        mask = ((sdf_input <= -1) & ~empty).astype(np.float32)
    sdf_in = np.clip(sdf_input, -truncation, truncation).astype(np.float32)
    input_colors_f = np.where(empty[..., None], 0.0, input_colors_f).astype(np.float32)

    sample = {
        "input": np.concatenate([sdf_in[..., None], input_colors_f], axis=-1),
        "mask": mask[..., None],
        "target_sdf": sdf_target.astype(np.float32),
        "target_colors": target_colors_f,
        "world2grid": world2grid.astype(np.float32),
    }
    if semantics is not None:
        sample["semantics"] = semantics.astype(np.uint8)
    if known is not None:
        sample["known"] = known.astype(np.uint8)
    return sample


def rescale_grids(
    sdf_input, sdf_target, input_colors, target_colors, known, world2grid, scale: float
):
    """Nearest-neighbor rescale of all grids by ``scale`` with SDF values
    scaled accordingly, and world2grid updated (reference
    scene_dataloader.py:170-192: torch F.interpolate default 'nearest' mode —
    used when training at a non-native chunk resolution or with
    scene_subsample_factor > 1)."""
    from scipy.ndimage import zoom

    def z3(g):
        return zoom(g, scale, order=0, grid_mode=False)

    sdf_input = z3(sdf_input) * scale
    sdf_target = z3(sdf_target) * scale

    def zc(c):
        return np.stack([z3(c[..., i]) for i in range(c.shape[-1])], -1)

    input_colors = zc(input_colors)
    target_colors = zc(target_colors)
    if known is not None:
        known = z3(known)
    s = np.diag([scale, scale, scale, 1.0]).astype(np.float32)
    world2grid = (s @ world2grid).astype(np.float32)
    return sdf_input, sdf_target, input_colors, target_colors, known, world2grid


def torch_bilinear_resize(
    img: np.ndarray, out_h: int, out_w: int, scale: float = 0.0
) -> np.ndarray:
    """Bit-replicate torch ``F.interpolate(mode='bilinear',
    align_corners=False)`` (no antialias) on a (C, H, W) array.

    torch maps destination pixel ``d`` to source coordinate
    ``(d + 0.5) * s - 0.5`` clamped below at 0, then lerps the two
    neighbors with edge-clamped indices (aten UpSampleLinear
    ``compute_source_index_and_lambda``). The kernel scale ``s`` is
    ``in/out`` when torch is called with ``size=`` but the *reciprocal of
    the given scale_factor* when called with ``scale_factor=`` (they differ
    when the factor doesn't divide the size) — pass ``scale`` to replicate
    the latter. Used for the ``--subsample_tgt2d_factor`` low-pass
    (reference scene_dataloader.py:161-167); equality vs torch is tested in
    tests/test_dataset_integration.py."""
    _, h, w = img.shape

    def axis(n_in, n_out):
        s = scale if scale > 0 else n_in / n_out
        x = (np.arange(n_out, dtype=np.float64) + 0.5) * s - 0.5
        x = np.maximum(x, 0.0)
        i0 = np.minimum(np.floor(x).astype(np.int64), n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
        t = (x - i0).astype(np.float32)
        return i0, i1, t

    r0, r1, tr = axis(h, out_h)
    c0, c1, tc = axis(w, out_w)
    rows = img[:, r0, :] * (1.0 - tr)[None, :, None] + img[:, r1, :] * tr[None, :, None]
    out = rows[:, :, c0] * (1.0 - tc)[None, None, :] + rows[:, :, c1] * tc[None, None, :]
    return out.astype(np.float32)


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack samples into a batch (reference scene_dataloader.py:15-47)."""
    batch: Dict[str, np.ndarray] = {}
    keys = set()
    for s in samples:
        keys.update(s.keys())
    for k in keys:
        if k == "name":
            batch["name"] = [s.get("name") for s in samples]
            continue
        vals = [s[k] for s in samples if k in s]
        if len(vals) != len(samples):
            continue  # drop optional keys missing from any sample
        batch[k] = np.stack(vals)
    return batch


# ---------------------------------------------------------------------------
# frame loading (reference torch/data_util.py:764-902)
# ---------------------------------------------------------------------------


def read_camera_file(camera_file: str):
    """Pose (4x4 cam->world) + intrinsics rows from a camera txt
    (reference data_util.py:774-787)."""
    lines = open(camera_file).read().splitlines()
    vals = np.asarray([l.split(" ")[:4] for l in lines], dtype=np.float32)
    pose = vals[:4]
    intrinsic = vals[4:8]
    return pose, intrinsic


def adjust_intrinsic(intrinsic: np.ndarray, from_dims, to_dims) -> np.ndarray:
    """Rescale a 4x4 intrinsic matrix for resize+center-crop
    (reference data_util.py:803-812)."""
    if tuple(from_dims) == tuple(to_dims):
        return intrinsic
    intrinsic = intrinsic.copy()
    resize_width = int(np.floor(to_dims[1] * float(from_dims[0]) / float(from_dims[1])))
    intrinsic[0, 0] *= float(resize_width) / float(from_dims[0])
    intrinsic[1, 1] *= float(to_dims[1]) / float(from_dims[1])
    intrinsic[0, 2] *= float(to_dims[0] - 1) / float(from_dims[0] - 1)
    intrinsic[1, 2] *= float(to_dims[1] - 1) / float(from_dims[1] - 1)
    return intrinsic


def _resize_crop(image: np.ndarray, new_dims, nearest=True) -> np.ndarray:
    """Resize so height matches then center-crop width
    (reference data_util.py:790-800). new_dims = (width, height)."""
    from PIL import Image

    h, w = image.shape[:2]
    if (w, h) == tuple(new_dims):
        return image
    resize_width = int(np.floor(new_dims[1] * float(w) / float(h)))
    im = Image.fromarray(image)
    im = im.resize((resize_width, new_dims[1]), Image.NEAREST if nearest else Image.BILINEAR)
    w2 = im.size[0]
    if w2 != new_dims[0]:
        left = (w2 - new_dims[0]) // 2
        im = im.crop((left, 0, left + new_dims[0], new_dims[1]))
    return np.array(im)


def load_frame(depth_file, color_file, camera_file, image_dims, load_depth=True, load_color=True):
    """One RGB-D frame: depth (H,W) meters, color (3,H,W) [0,1], pose,
    intrinsics [fx,fy,mx,my] (reference data_util.py:837-859)."""
    from PIL import Image

    pose, intrinsic = read_camera_file(camera_file)
    depth = None
    color = None
    orig_dims = None
    if load_depth:
        d = np.array(Image.open(depth_file))
        orig_dims = [d.shape[1], d.shape[0]]
        d = _resize_crop(d, image_dims, nearest=True)
        depth = d.astype(np.float32) / 1000.0
    if load_color:
        c = np.array(Image.open(color_file).convert("RGB"))
        orig_dims = [c.shape[1], c.shape[0]]
        c = _resize_crop(c, image_dims, nearest=True)
        color = np.transpose(c.astype(np.float32) / 255.0, (2, 0, 1))
    if orig_dims is not None and list(image_dims) != orig_dims:
        intrinsic = adjust_intrinsic(intrinsic, orig_dims, image_dims)
    params = np.array(
        [intrinsic[0, 0], intrinsic[1, 1], intrinsic[0, 2], intrinsic[1, 2]],
        dtype=np.float32,
    )
    return depth, color, pose, params


def read_frame_ids(frame_file: str, randomize: bool, max_num: int, rng=None):
    """Frame-association ids for a chunk (reference data_util.py:764-771)."""
    frames = [int(l) for l in open(frame_file).read().splitlines()]
    frames = [f for f in frames if f != -1]
    if randomize:
        (rng or np.random.default_rng()).shuffle(frames)
    return frames[:max_num]


# ---------------------------------------------------------------------------
# chunk dataset + prefetching iterator
# ---------------------------------------------------------------------------


class ChunkDataset:
    """File-backed chunk dataset (reference SceneDataset chunk mode,
    scene_dataloader.py:50-265).

    Pairs ``__inc__`` inputs with ``__cmp__`` (or ``__sem__`` when
    load_semantic) targets; loads known/colors inline from the chunk files."""

    def __init__(
        self,
        files: Sequence[str],
        truncation: float = 3.0,
        color_space: str = "lab",
        augment_hue: bool = True,
        aug_scale_range=(0.5, 1.5),
        color_truncation: float = 0.0,
        load_semantic: bool = False,
        frame_info_path: str = "",
        frame_path: str = "",
        image_dims=(320, 256),
        load_depth: bool = False,
        randomize_frames: bool = True,
        num_overfit: int = 0,
        seed: int = 0,
        input_dim=None,
        max_num_frames: int = 1,
        subsamp2d_factor: int = 1,
    ):
        self.max_num_frames = max_num_frames
        self.subsamp2d_factor = subsamp2d_factor
        # rescale chunks when training at a non-native resolution (reference
        # scene_dataloader.py:170-175: native z-heights are 96/128/160); the
        # factor is resolved per chunk from its actual height in __getitem__
        # so chunks already cut at input_dim load unscaled
        self.target_height = None
        if input_dim is not None and input_dim[0] not in (96, 128, 160):
            self.target_height = int(input_dim[0])
        tgt_tag = "__sem__" if load_semantic else "__cmp__"
        self.pairs = [
            (f, f.replace("__inc__", tgt_tag))
            for f in files
            if os.path.isfile(f) and os.path.isfile(f.replace("__inc__", tgt_tag))
        ]
        if num_overfit > 0 and self.pairs:
            self.pairs = self.pairs * max(1, num_overfit // len(self.pairs))
        self.truncation = truncation
        self.color_space = color_space
        self.augment_hue = augment_hue
        self.aug_scale_range = aug_scale_range
        self.color_truncation = color_truncation
        self.load_semantic = load_semantic
        self.frame_info_path = frame_info_path
        self.frame_path = frame_path
        self.image_dims = image_dims
        self.load_depth = load_depth
        self.randomize_frames = randomize_frames
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        inc_file, tgt_file = self.pairs[idx]
        name = os.path.splitext(os.path.basename(inc_file))[0]
        tgt = formats.load_sdf(
            tgt_file, load_known=True, load_color=True, load_semantic=self.load_semantic
        )
        inp = formats.load_sdf(inc_file, load_known=False, load_color=True)
        dims = tgt.dims
        if self.color_truncation > 0:
            m = np.abs(inp.sdf) > self.color_truncation
            locs = inp.locs[m]
            inp.colors[locs[:, 0], locs[:, 1], locs[:, 2], :] = 0
        in_bounds = (
            (inp.locs[:, 0] < dims[0]) & (inp.locs[:, 1] < dims[1]) & (inp.locs[:, 2] < dims[2])
        )
        locs, sdf = inp.locs[in_bounds], inp.sdf[in_bounds]
        sdf_input = formats.sparse_to_dense(locs, sdf[:, None], dims, -np.inf)
        sdf_target = formats.sparse_to_dense(tgt.locs, tgt.sdf[:, None], dims, -np.inf)
        input_colors = inp.colors
        target_colors = tgt.colors
        known = tgt.known
        world2grid = tgt.world2grid
        semantics = tgt.semantics
        if self.target_height is not None and dims[0] != self.target_height:
            rescale = float(self.target_height) / float(dims[0])
            (sdf_input, sdf_target, input_colors, target_colors, known, world2grid) = (
                rescale_grids(
                    sdf_input, sdf_target, input_colors, target_colors, known,
                    world2grid, rescale,
                )
            )
            if semantics is not None:
                from scipy.ndimage import zoom

                semantics = zoom(semantics, rescale, order=0, grid_mode=False)

        scale = None
        if self.augment_hue:
            lo, hi = self.aug_scale_range
            scale = float(self.rng.random() * (hi - lo) + lo)
        sample = assemble_sample(
            sdf_input=sdf_input,
            sdf_target=sdf_target,
            input_colors=input_colors,
            target_colors=target_colors,
            semantics=semantics,
            known=known,
            world2grid=world2grid,
            truncation=self.truncation,
            color_space=self.color_space,
            augment_hue_scale=scale,
        )
        sample["name"] = name

        if self.frame_info_path and self.frame_path:
            frames = self._load_frames_for(name)
            if frames is None:
                sample["frames_missing"] = np.array(True)
            else:
                depths, colors_f, poses, intrs, frame_ids = frames
                if self.subsamp2d_factor > 1:
                    # low-pass the target frame colors: bilinear downsample by
                    # the factor, then back up (reference
                    # scene_dataloader.py:161-167; applied before color-space
                    # conversion), replicating torch's align_corners=False
                    # bilinear kernel exactly (tests/test_dataset_integration.py)

                    def _lowpass(c):  # (3, H, W) float
                        h, w = c.shape[1:]
                        f = self.subsamp2d_factor
                        # down uses scale_factor semantics, up uses size=
                        small = torch_bilinear_resize(c, h // f, w // f, scale=f)
                        return torch_bilinear_resize(small, h, w)

                    colors_f = [_lowpass(c) for c in colors_f]
                if self.color_space == "lab":
                    converted = []
                    for color in colors_f:
                        c = np.transpose(color, (1, 2, 0))
                        c = colorspace.rgb_to_lab01(c)
                        converted.append(np.transpose(c, (2, 0, 1)).astype(np.float32))
                    colors_f = converted
                views = [
                    (sample["world2grid"] @ pose).astype(np.float32) for pose in poses
                ]
                # which frames were (randomly) selected — lets the training
                # loop key its per-(chunk, frames) render cache (loop.py)
                sample["frame_ids"] = np.asarray(frame_ids, np.int64)
                if self.max_num_frames == 1:
                    sample["images_depth"] = depths[0]
                    sample["images_color"] = colors_f[0]
                    sample["images_view"] = views[0]
                    sample["images_intrinsic"] = intrs[0]
                else:  # (F, ...) stacks -> (B, F, ...) after collate
                    sample["images_depth"] = np.stack(depths)
                    sample["images_color"] = np.stack(colors_f)
                    sample["images_view"] = np.stack(views)
                    sample["images_intrinsic"] = np.stack(intrs)
        return sample

    def _load_frames_for(self, name: str):
        """Load max_num_frames RGB-D frames for a chunk (reference
        load_frames, data_util.py:862-902; returns None when not enough
        frames exist — the reference skip, data_util.py:874-876)."""
        # scene dir: Matterport chunk names are "<scene>_room<k>__inc__<i>"
        # (reference scene_dataloader.py:143-166); datagen-produced names may
        # lack the "_room" part, so strip the chunk suffix first
        scene = name.split("__inc__")[0].split("_room")[0]
        frame_file = os.path.join(
            self.frame_info_path, name.replace("__inc__", "__cmp__") + ".txt"
        )
        if self.frame_path == "self":
            ids = [int(name.split("__inc__")[1])]
        else:
            if not os.path.isfile(frame_file):
                return None
            ids = read_frame_ids(
                frame_file, self.randomize_frames, self.max_num_frames, self.rng
            )
        if len(ids) < self.max_num_frames:
            return None
        base = os.path.join(self.frame_path, scene)
        depths, colors_f, poses, intrs = [], [], [], []
        for f in ids:
            try:
                depth, color, pose, intr = load_frame(
                    os.path.join(base, "depth", f"{f}.png"),
                    os.path.join(base, "color", f"{f}.jpg"),
                    os.path.join(base, "camera", f"{f}.txt"),
                    self.image_dims,
                    load_depth=self.load_depth,
                )
            except (OSError, ValueError):
                return None
            depths.append(depth)
            colors_f.append(color)
            poses.append(pose)
            intrs.append(intr)
        return depths, colors_f, poses, intrs, ids


class SceneDataset:
    """Full-scene dataset (reference SceneDataset scene mode,
    scene_dataloader.py:56-66, 103-126): pairs an incomplete scene .sdf with
    the complete target of the same basename in ``target_path``, loading
    .colors/.semantics sidecars and the .knw known grid."""

    def __init__(
        self,
        files: Sequence[str],
        target_path: str,
        truncation: float = 3.0,
        color_space: str = "lab",
        load_semantic: bool = False,
        load_known: bool = True,
        max_input_height: int = 0,
        color_truncation: float = 0.0,
        augment_hue: bool = False,
        aug_scale_range=(0.5, 1.5),
        seed: int = 0,
        keep_raw: bool = False,
    ):
        # keep_raw: also return the pre-assembly raw input grids (f32 sdf +
        # u8 rgb) so eval can feed them to the device directly and run
        # clamp/LAB/mask there (inference/chunked.py compact_scene)
        self.keep_raw = keep_raw
        self.pairs = [
            (f, os.path.join(target_path, os.path.basename(f)))
            for f in files
            if os.path.isfile(f) and os.path.isfile(os.path.join(target_path, os.path.basename(f)))
        ]
        self.truncation = truncation
        self.color_space = color_space
        self.load_semantic = load_semantic
        self.load_known = load_known
        self.max_input_height = max_input_height
        # eval-time knobs matching the reference SceneDataset signature
        # (scene_dataloader.py:53-66): color truncation masking + optional hue
        # augmentation (off by default at test, test_scene_as_chunks.py:50)
        self.color_truncation = color_truncation
        self.augment_hue = augment_hue
        self.aug_scale_range = aug_scale_range
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        inc_file, tgt_file = self.pairs[idx]
        name = os.path.splitext(os.path.basename(inc_file))[0]
        base = os.path.splitext(tgt_file)[0]
        color_path = base + ".colors"
        sem_path = base + ".semantics"
        tgt = formats.load_sdf(
            tgt_file,
            load_color=os.path.isfile(color_path),
            load_semantic=self.load_semantic and os.path.isfile(sem_path),
            color_path=color_path if os.path.isfile(color_path) else None,
            semantic_path=sem_path if os.path.isfile(sem_path) else None,
        )
        inp = formats.load_sdf(
            inc_file,
            load_color=os.path.isfile(os.path.splitext(inc_file)[0] + ".colors"),
            color_path=(os.path.splitext(inc_file)[0] + ".colors")
            if os.path.isfile(os.path.splitext(inc_file)[0] + ".colors")
            else None,
        )
        dims = tgt.dims
        known = None
        if self.load_known:
            # .knw next to the target (reference path mangling
            # scene_dataloader.py:116-122 is dataset-layout specific; we look
            # for the plain sidecar and rescale when at half resolution)
            knw_path = base + ".knw"
            if os.path.isfile(knw_path):
                known, _, _ = formats.load_known(knw_path)
                if known.shape != dims:
                    known = formats.rescale_known(known, (3, 3, 3), (3, 6, 6), dims)
        if self.color_truncation > 0 and inp.colors is not None:
            m = np.abs(inp.sdf) > self.color_truncation
            locs_m = inp.locs[m]
            inp.colors[locs_m[:, 0], locs_m[:, 1], locs_m[:, 2], :] = 0
        in_bounds = (
            (inp.locs[:, 0] < dims[0]) & (inp.locs[:, 1] < dims[1]) & (inp.locs[:, 2] < dims[2])
        )
        locs, sdf = inp.locs[in_bounds], inp.sdf[in_bounds]
        sdf_input = formats.sparse_to_dense(locs, sdf[:, None], dims, -np.inf)
        sdf_target = formats.sparse_to_dense(tgt.locs, tgt.sdf[:, None], dims, -np.inf)
        input_colors = (
            inp.colors if inp.colors is not None else np.zeros(dims + (3,), np.uint8)
        )
        target_colors = (
            tgt.colors if tgt.colors is not None else np.zeros(dims + (3,), np.uint8)
        )
        scale = None
        if self.augment_hue:
            lo, hi = self.aug_scale_range
            scale = float(self.rng.random() * (hi - lo) + lo)
        sample = assemble_sample(
            sdf_input=sdf_input,
            sdf_target=sdf_target,
            input_colors=input_colors,
            target_colors=target_colors,
            semantics=tgt.semantics,
            known=known,
            world2grid=tgt.world2grid,
            truncation=self.truncation,
            color_space=self.color_space,
            augment_hue_scale=scale,
        )
        sample["name"] = name
        if self.keep_raw:
            sample["raw_sdf_input"] = sdf_input.astype(np.float32)
            sample["raw_input_colors"] = input_colors
        return sample


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    num_prefetch: int = 4,
    num_workers: int = 4,
    indices=None,
):
    """Thread-prefetched batch iterator replacing torch DataLoader
    (reference train.py:196-211). Drops undersized trailing batches like the
    reference's skip at train.py:425-427. ``indices`` overrides the sample
    order (multi-host: each process passes its slice from
    parallel.multihost.local_indices and its per-host batch size)."""
    if indices is not None:
        order = np.asarray(indices)
    else:
        order = np.arange(len(dataset))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
    batches = [
        order[i : i + batch_size]
        for i in range(0, len(order) - (batch_size - 1 if drop_remainder else 0), batch_size)
    ]

    q: "queue.Queue" = queue.Queue(maxsize=num_prefetch)
    stop = threading.Event()

    def _producer():
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        # bounded submission window: at most num_prefetch + num_workers
        # batches are in flight or buffered, so memory stays O(prefetch)
        # regardless of dataset size
        with ThreadPoolExecutor(max_workers=num_workers) as ex:
            window: "deque" = deque()
            it = iter(batches)
            try:
                while True:
                    while len(window) < num_prefetch + num_workers:
                        b = next(it, None)
                        if b is None:
                            break
                        window.append(
                            ex.submit(lambda b=b: collate([dataset[i] for i in b]))
                        )
                    if not window:
                        break
                    if stop.is_set():
                        return
                    q.put(window.popleft().result())
            finally:
                for f in window:
                    f.cancel()
        q.put(None)

    t = threading.Thread(target=_producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            yield item
    finally:
        stop.set()

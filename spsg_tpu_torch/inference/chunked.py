"""Whole-scene completion by sliding-window chunking with overlap stitching
(PyTorch counterpart of ``spsg_tpu/inference/chunked.py``, itself a rebuild of
reference torch/test_scene_as_chunks.py:92-330).

The reference runs one 64x64x128 window at a time through the generator and
accumulates SDF/color/semantic sums + counts into scene-sized buffers, masking
away a pad-voxel border on stitched sides. Here windows are **batched**: all
window positions are gathered up front and run ``window_batch`` at a time
through the generator; window extraction, stitching, the IoU accumulators and
the final normalisation all stay on the device, and the host reads the
compact results once at the end.

Stitching is the slice read-modify-write form of the JAX package
(``update_rmw``): shaped accumulators padded like the input scene, one
in-place slice update per window. On CUDA this is deterministic, which a
floating-point ``index_add_`` is not.

With ``mesh=`` (``parallel.make_mesh()``, one process a device) every window
batch splits over the ranks: each runs its share of the windows through the
generator, the outputs are gathered in window order and rank 0 stitches them
and accumulates the IoU over every window, in the one-process order.

With the recorder of ``utils/timing.py`` on, a call is one span tree:
``serve.room`` → ``serve.prep`` (from entry until the padded scene is on the
device), ``serve.stitcher_init``, ``serve.batch`` a window batch (→
``serve.gather``, ``serve.forward``, ``serve.stitch``), ``serve.finalize`` (→
``serve.normalize``, ``serve.readback``, both marked on the stream); the
counters are ``serve.rooms``, ``serve.windows``, ``serve.batches`` and
``serve.bytes_up`` / ``serve.bytes_down``, the sizes of the arrays that cross
(:func:`_upload`, :func:`_download`). ``summarize_iou`` is the span
``serve.iou``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data import category, colorspace
from ..parallel import mesh as pmesh
from ..training.state import resolve_device
from ..utils import timing


@dataclasses.dataclass
class SceneOutputs:
    sdf: np.ndarray  # (Z, Y, X) stitched, -inf where no prediction
    colors: Optional[np.ndarray]  # (Z, Y, X, 3) uint8 in [0, 255]
    # named sem_labels (NOT `semantics`): (Z,Y,X) uint8 argmax labels computed
    # on the device, not the (Z,Y,X,14) accumulated logits
    sem_labels: Optional[np.ndarray]  # (Z, Y, X) uint8 argmax labels
    occ: np.ndarray  # (Z, Y, X) bool
    counts: np.ndarray  # (Z, Y, X) overlap counts
    geo_intersection: int
    geo_union: int
    class_intersection: np.ndarray  # (14,)
    class_union: np.ndarray  # (14,)
    class_weight: np.ndarray  # (14,) target voxel counts per class


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, its size counted in ``serve.bytes_up``."""
    timing.count("serve.bytes_up", a.nbytes)
    return torch.from_numpy(a).to(device)


def _download(t: torch.Tensor) -> np.ndarray:
    """A tensor read back to the host, its size counted in ``serve.bytes_down``."""
    a = t.cpu().numpy()
    timing.count("serve.bytes_down", a.nbytes)
    return a


def prep_compact_scene(sdf, rgb, truncation, lab, pads):
    """Device-side compact-scene assembly: ``data/pipeline.py::assemble_sample``'s
    math (scene_dataloader.py:222-253: the truncation clamp, RGB -> [0,1] LAB,
    colours of empty voxels zeroed, the input mask) on the raw scene, then the
    window padding with the reference fill values (test_scene_as_chunks.py:166-180:
    sdf -> -truncation, colours and mask -> 0). ``sdf`` (Z,Y,X) float32 and
    ``rgb`` (Z,Y,X,3) uint8 are tensors on the device; ``pads`` = (z, y, x).
    Returns (scene (Z+pz,Y+py,X+px,4), mask (..., 1)) float32."""
    Z, Y, X = sdf.shape
    empty = sdf.abs() > truncation
    m = ((sdf <= -1) & ~empty).float()
    col = rgb.float() / 255.0
    if lab:
        col = colorspace.rgb_to_lab01(col, xp=torch)
    col = torch.where(empty[..., None], 0.0, col)
    sin = torch.cat([torch.clamp(sdf, -truncation, truncation)[..., None], col], dim=-1)
    widths = (0, 0, 0, pads[2], 0, pads[1], 0, pads[0])
    sin = F.pad(sin, widths)
    sin[Z:, :, :, 0] = -truncation
    sin[:, Y:, :, 0] = -truncation
    sin[:, :, X:, 0] = -truncation
    return sin, F.pad(m[..., None], widths)


def window_positions(scene_dims_yx, stride) -> np.ndarray:
    # Positions depend only on scene extent + stride (windows past the edge
    # are padded downstream, reference test_scene_as_chunks.py:156-277
    # semantics) — the window extent deliberately does NOT clamp positions.
    ys = list(range(0, scene_dims_yx[0], stride))
    xs = list(range(0, scene_dims_yx[1], stride))
    return np.array([(y, x) for y in ys for x in xs], dtype=np.int32)


class _Stitcher:
    """Scene-sized accumulators on ``device`` and the per-window-batch update
    (``update_rmw`` of the JAX package) plus ``finalize``."""

    def __init__(self, scene_dims, chunk_dims, stride, pad, truncation, pred_color,
                 pred_semantic, target_sdf, known, target_semantics, device):
        self.Z, self.Y, self.X = Z, Y, X = tuple(int(d) for d in scene_dims)
        self.cz, self.cy, self.cx = cz, cy, cx = chunk_dims
        self.stride, self.pad, self.truncation = stride, pad, truncation
        self.pred_color, self.pred_semantic = pred_color, pred_semantic
        self.device = device
        self.n_classes = n_classes = category.NUM_CLASSES
        self.has_target = target_sdf is not None
        self.has_sem_target = (
            self.has_target and target_semantics is not None and pred_semantic
        )
        pz = max(0, cz - Z)
        if self.has_target:
            # padded SHAPED targets: a window is a plain slice. Fill values
            # reproduce the reference's beyond-scene chunk fills
            # (test_scene_as_chunks.py:166-180): sdf -> inf (never occupied),
            # known -> True, semantics -> UNLABELED.
            pad3 = ((0, pz), (0, cy), (0, cx))
            tgt = np.ascontiguousarray(target_sdf[:Z]).astype(np.float32)
            kn = (np.ascontiguousarray(known[:Z] <= 1) if known is not None
                  else np.ones((Z, Y, X), bool))
            sm = (np.ascontiguousarray(target_semantics[:Z]).astype(np.int32)
                  if target_semantics is not None
                  else np.full((Z, Y, X), category.UNLABELED, np.int32))
            self.tgt = _upload(np.pad(tgt, pad3, constant_values=np.inf), device)
            self.kn = _upload(np.pad(kn, pad3, constant_values=True), device)
            self.sm = _upload(np.pad(sm, pad3, constant_values=category.UNLABELED), device)

        shp = (Z + pz, Y + cy, X + cx)
        zeros = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
        self.acc = dict(
            sdf=zeros(shp, torch.float32),
            counts=zeros(shp, torch.int32),
            occ=zeros(shp, torch.int32),
            geo_i=zeros((), torch.int32),
            geo_u=zeros((), torch.int32),
            cls_i=zeros((n_classes,), torch.int32),
            cls_u=zeros((n_classes,), torch.int32),
            cls_w=zeros((n_classes,), torch.int32),
        )
        if pred_color:
            self.acc["color"] = zeros(shp + (3,), torch.float32)
        if pred_semantic:
            self.acc["sem"] = zeros(shp + (n_classes,), torch.float32)
        ar = lambda n: torch.arange(n, dtype=torch.int32, device=device)
        self.zz = ar(cz)[:, None, None]
        self.yy = ar(cy)[None, :, None]
        self.xx = ar(cx)[None, None, :]

    def update(self, occ_l, sdf_p, color_p, sem_p, positions, n_real: int) -> None:
        """Stitch one window batch. ``positions`` are host ints (y, x);
        windows from ``n_real`` on are padding and contribute nothing."""
        Z, Y, X = self.Z, self.Y, self.X
        cz, cy, cx = self.cz, self.cy, self.cx
        pad, trunc, acc = self.pad, self.truncation, self.acc
        zz, yy, xx = self.zz, self.yy, self.xx
        occ_l = occ_l[..., 0]
        sdf_p = sdf_p[..., 0]
        occ = torch.sigmoid(occ_l) > 0.5
        surf = (sdf_p.abs() < trunc) & occ
        for i in range(min(n_real, occ.shape[0])):
            y, x = positions[i]
            in_scene = (zz < Z) & (yy + y < Y) & (xx + x < X)
            # interior mask (test_scene_as_chunks.py:216-236)
            inter = in_scene
            if self.stride < cy:
                if y > 0:
                    inter = inter & ~(yy < pad)
                if x > 0:
                    inter = inter & ~(xx < pad)
                if y + cy < Y:
                    inter = inter & ~(yy >= cy - pad)
                if x + cx < X:
                    inter = inter & ~(xx >= cx - pad)
            keep = inter & surf[i]
            win = (slice(0, cz), slice(y, y + cy), slice(x, x + cx))

            acc["sdf"][win] += torch.where(keep, sdf_p[i], 0.0)
            acc["counts"][win] += keep.to(torch.int32)
            if self.pred_color:
                acc["color"][win] += torch.where(keep[..., None], (color_p[i] + 1.0) * 0.5, 0.0)
            if self.pred_semantic:
                acc["sem"][win] += torch.where(keep[..., None], sem_p[i], 0.0)
            # occ: OR over windows in the clipped extent (the host reference
            # overwrites in window order; OR differs only where overlapping
            # windows disagree — the grid is informational, unused by metrics)
            blk = acc["occ"][win]
            torch.maximum(blk, (occ[i] & in_scene).to(torch.int32), out=blk)

            if self.has_target:
                tgt_occ = self.tgt[win].abs() < trunc
                kn = self.kn[win]
                occ_r = occ[i]
                acc["geo_i"] += (occ_r & tgt_occ & kn).sum(dtype=torch.int32)
                acc["geo_u"] += ((occ_r | tgt_occ) & kn).sum(dtype=torch.int32)
                if self.has_sem_target:
                    sm = self.sm[win].long().clamp(max=category.UNLABELED)
                    lbl = torch.argmax(sem_p[i], dim=-1)
                    sem_known = kn & (sm != category.UNLABELED)
                    nc = self.n_classes
                    # one_hot over nc + 1 classes, UNLABELED (== nc) dropped
                    p1 = F.one_hot(lbl, nc).to(torch.int32) * occ_r[..., None]
                    t_all = F.one_hot(sm, nc + 1)[..., :nc].to(torch.int32)
                    t1 = t_all * tgt_occ[..., None]
                    k1 = sem_known[..., None].to(torch.int32)
                    acc["cls_i"] += (p1 * t1 * k1).sum(dim=(0, 1, 2), dtype=torch.int32)
                    acc["cls_u"] += (((p1 + t1) > 0).to(torch.int32) * k1).sum(
                        dim=(0, 1, 2), dtype=torch.int32)
                    acc["cls_w"] += t_all.sum(dim=(0, 1, 2), dtype=torch.int32)

    def finalize(self) -> Dict[str, np.ndarray]:
        """Normalise on the device (test_scene_as_chunks.py:270-280) and read
        the compact results back in one go."""
        Z, Y, X = self.Z, self.Y, self.X
        trunc = self.truncation
        with timing.span("serve.normalize", stream=True):
            acc = {k: (v[:Z, :Y, :X] if v.dim() >= 3 else v) for k, v in self.acc.items()}
            counts = acc["counts"]
            got = counts > 0
            cf = torch.clamp(counts.float(), min=1.0)
            neg_inf = torch.full((), float("-inf"), device=self.device)
            out = dict(
                counts=counts.to(torch.int16),  # overlaps <= (chunk/stride)^2
                occ=acc["occ"].bool(),
                geo_i=acc["geo_i"], geo_u=acc["geo_u"],
                cls_i=acc["cls_i"], cls_u=acc["cls_u"], cls_w=acc["cls_w"],
                sdf=torch.where(got, torch.clamp(acc["sdf"] / cf, -trunc, trunc), neg_inf),
            )
            if self.pred_color:
                # u8, rounded half to even like the JAX package
                col = torch.clamp(acc["color"] / cf[..., None] * 255.0, 0.0, 255.0)
                out["color"] = torch.round(torch.where(got[..., None], col, 0.0)).to(torch.uint8)
            if self.pred_semantic:
                # torch.argmax, like jnp.argmax, takes the first maximum
                out["sem_label"] = torch.argmax(acc["sem"], dim=-1).to(torch.uint8)
        with timing.span("serve.readback", stream=True):
            return {k: _download(v) for k, v in out.items()}


def _outputs(fin, pred_color, pred_semantic) -> SceneOutputs:
    return SceneOutputs(
        sdf=fin["sdf"],
        colors=fin["color"] if pred_color else None,
        sem_labels=fin["sem_label"] if pred_semantic else None,
        occ=fin["occ"],
        counts=fin["counts"].astype(np.uint16),
        geo_intersection=int(fin["geo_i"]),
        geo_union=int(fin["geo_u"]),
        class_intersection=fin["cls_i"].astype(np.int64),
        class_union=fin["cls_u"].astype(np.int64),
        class_weight=fin["cls_w"].astype(np.int64),
    )


def stitch_window_outputs(
    batches,
    scene_dims: Tuple[int, int, int],
    target_sdf: Optional[np.ndarray],
    known: Optional[np.ndarray],
    target_semantics: Optional[np.ndarray],
    truncation: float = 3.0,
    chunk_dims: Tuple[int, int, int] = (128, 64, 64),
    stride: int = 32,
    pad: int = 2,
    pred_color: bool = True,
    pred_semantic: bool = True,
    device="cuda",
) -> SceneOutputs:
    """Stitch network outputs that were computed elsewhere. ``batches`` yields
    ``(positions, n_real, occ_logits, sdf, color, semantic)`` per window batch
    (numpy arrays or tensors shaped as the generator returns them). Separates
    the stitcher from the network, e.g. to hold it against the JAX package's
    on identical inputs."""
    device = resolve_device(device)
    st = _Stitcher(scene_dims, chunk_dims, stride, pad, truncation, pred_color,
                   pred_semantic, target_sdf, known, target_semantics, device)

    def to(a):
        if a is None or isinstance(a, torch.Tensor):
            return a if a is None else a.to(device)
        return torch.from_numpy(np.array(a)).to(device)

    for positions, n_real, occ_l, sdf_p, color_p, sem_p in batches:
        pos = [(int(y), int(x)) for y, x in positions]
        st.update(to(occ_l), to(sdf_p), to(color_p), to(sem_p), pos, int(n_real))
    return _outputs(st.finalize(), pred_color, pred_semantic)


def run_chunked_inference(
    generator,
    scene_input: np.ndarray,  # (Z, Y, X, 4)
    scene_mask: np.ndarray,  # (Z, Y, X, 1)
    target_sdf: Optional[np.ndarray],  # (Z, Y, X) for IoU; may be None
    known: Optional[np.ndarray],
    target_semantics: Optional[np.ndarray],
    truncation: float = 3.0,
    chunk_dims: Tuple[int, int, int] = (128, 64, 64),
    stride: int = 32,
    pad: int = 2,
    max_height: int = 128,
    window_batch: int = 8,
    pred_color: bool = True,
    pred_semantic: bool = True,
    mesh=None,
    skip_empty_windows: bool = False,
    scan_windows: bool = False,
    compact_scene: Optional[Dict[str, np.ndarray]] = None,
    stitch_slices: bool = False,
    device="cuda",
) -> SceneOutputs:
    """Stitched scene completion + IoU accumulation.

    ``generator`` is a ``models.Generator`` (its parameters are moved to
    ``device`` if they are elsewhere); it runs in eval mode under
    ``torch.no_grad()``. ``device`` defaults to the GPU and raises if there is
    none; pass ``"cpu"`` to run on the CPU.

    ``compact_scene`` feeds the device the raw scene instead of the assembled
    float32 sample: ``{"sdf": (Z,Y,X) float raw input SDF, "colors": (Z,Y,X,3)
    uint8 RGB, "color_space": "lab"|"rgb"}``; the clamp, the colour encoding,
    the input mask and the padding then run on the device
    (:func:`prep_compact_scene`), and ``scene_input`` / ``scene_mask`` may be
    None. Its colours must be uint8 and its SDF floating (``TypeError``
    otherwise), as in the JAX package.

    ``scan_windows`` and ``stitch_slices`` steer the JAX package's dispatch
    and stitching; here there is one form of each (a Python loop over window
    batches, slice read-modify-write stitching) and both are accepted without
    effect.

    ``mesh`` (``parallel.Mesh``): every rank calls this with the same
    arguments; each runs ``window_batch / ranks`` windows of every batch (the
    world size must divide ``window_batch``), rank 0 stitches the gathered
    outputs and returns the scene, the other ranks return None."""
    span = timing.span
    with span("serve.room"), torch.no_grad():
        timing.count("serve.rooms")
        with span("serve.prep"):
            mesh = pmesh.check_mesh(mesh)
            sharded = pmesh.active(mesh)
            n_ranks = mesh.size if sharded else 1
            if window_batch % n_ranks:
                raise ValueError(
                    f"window_batch {window_batch} does not split over {n_ranks} ranks")
            per_rank = window_batch // n_ranks
            stitching = not sharded or mesh.rank == 0
            raw_sdf = raw_rgb = None
            if compact_scene is not None:
                raw_sdf = compact_scene["sdf"]
                raw_rgb = compact_scene["colors"]
                # a float RGB cast to uint8 would be truncated, not divided by 255
                if raw_rgb.dtype != np.uint8:
                    raise TypeError(
                        f"compact_scene['colors'] must be uint8 in [0,255], got {raw_rgb.dtype}")
                if not np.issubdtype(raw_sdf.dtype, np.floating):
                    raise TypeError(
                        f"compact_scene['sdf'] must be floating, got {raw_sdf.dtype}")
                scene_zyx = raw_sdf.shape[:3]
            else:
                scene_zyx = scene_input.shape[:3]
            device = resolve_device(device)
            # crop height (test_scene_as_chunks.py:120-132)
            if max_height > 0 and scene_zyx[0] > max_height:
                if compact_scene is not None:
                    raw_sdf = raw_sdf[:max_height]
                    raw_rgb = raw_rgb[:max_height]
                else:
                    scene_input = scene_input[:max_height]
                    scene_mask = scene_mask[:max_height]
                if target_sdf is not None:
                    target_sdf = target_sdf[:max_height]
                if known is not None:
                    known = known[:max_height]
                if target_semantics is not None:
                    target_semantics = target_semantics[:max_height]
            scene_dims = raw_sdf.shape[:3] if compact_scene is not None else scene_input.shape[:3]
            cz, cy, cx = chunk_dims
            Z, Y, X = (int(d) for d in scene_dims)

            # Window selection: the reference's "empty chunk" test
            # (test_scene_as_chunks.py:158-160) includes the [0,1] color channels in
            # its occupancy check, so it effectively never skips an in-bounds window —
            # every window gets a prediction and enters the IoU accumulators. We match
            # that (process all windows); `skip_empty_windows=True` restores the
            # stricter SDF-only skip as an opt-in speed knob (metrics then become
            # incomparable to reference numbers on scenes with empty-input windows).
            positions = []
            for y, x in window_positions(scene_dims[1:], stride):
                if skip_empty_windows:
                    # raw or clamped alike: |clip(s, +-t)| < t iff |s| < t
                    win = (raw_sdf[:cz, y:y + cy, x:x + cx] if compact_scene is not None
                           else scene_input[:cz, y:y + cy, x:x + cx, 0])
                    if not np.any(np.abs(win) < truncation):
                        continue
                positions.append((int(y), int(x)))
            if not positions:
                raise ValueError("scene has no occupied windows")
            n_win = len(positions)
            n_batches = -(-n_win // window_batch)  # ceil: the last partial batch runs padded
            timing.count("serve.windows", n_win)

            # The scene is padded once with the reference fill values (sdf ->
            # -truncation, colors/mask -> 0, test_scene_as_chunks.py:166-180) so a
            # window slice never clamps; it lives on the device and windows are
            # sliced there.
            pad_z = max(0, cz - Z)
            if compact_scene is not None:
                scene_in_dev, scene_mask_dev = prep_compact_scene(
                    _upload(np.ascontiguousarray(raw_sdf, dtype=np.float32), device),
                    _upload(np.ascontiguousarray(raw_rgb), device), float(truncation),
                    compact_scene.get("color_space", "lab") == "lab", (pad_z, cy, cx))
            else:
                widths = ((0, pad_z), (0, cy), (0, cx), (0, 0))
                scene_in_pad = np.pad(scene_input.astype(np.float32), widths)
                scene_in_pad[Z:, :, :, 0] = -truncation
                scene_in_pad[:, Y:, :, 0] = -truncation
                scene_in_pad[:, :, X:, 0] = -truncation
                scene_in_dev = _upload(scene_in_pad, device)
                scene_mask_dev = _upload(np.pad(scene_mask.astype(np.float32), widths), device)
        with span("serve.stitcher_init"):
            st = (_Stitcher(scene_dims, chunk_dims, stride, pad, truncation, pred_color,
                            pred_semantic, target_sdf, known, target_semantics, device)
                  if stitching else None)

        generator = generator.to(device)
        was_training = generator.training
        generator.eval()
        try:
            for bidx in range(n_batches):
                start = bidx * window_batch
                n_real = min(window_batch, n_win - start)
                # the padded tail of the last batch repeats position (0, 0)
                pos = positions[start:start + n_real] + [(0, 0)] * (window_batch - n_real)
                mine = pos[mesh.rank * per_rank:(mesh.rank + 1) * per_rank] if sharded else pos
                with span("serve.batch"):
                    timing.count("serve.batches")
                    with span("serve.gather"):
                        cb, mb = (torch.stack([t[:cz, y:y + cy, x:x + cx] for y, x in mine])
                                  for t in (scene_in_dev, scene_mask_dev))
                    with span("serve.forward"):
                        outs = generator(cb, mb, pred_color=pred_color, pred_sdf=True,
                                         pred_semantic=pred_semantic)
                        if sharded:  # the batch's outputs in window order, on every rank
                            outs = [None if o is None else pmesh.gather(o, mesh) for o in outs]
                    if st is not None:
                        with span("serve.stitch", stream=True):
                            st.update(*outs, pos, n_real)
            if st is None:
                return None
            with span("serve.finalize"):
                return _outputs(st.finalize(), pred_color, pred_semantic)
        finally:
            generator.train(was_training)


def summarize_iou(
    geo_i: int,
    geo_u: int,
    cls_i: np.ndarray,
    cls_u: np.ndarray,
    cls_w: np.ndarray,
    class_names=category.CLASS_NAMES,
) -> Dict:
    """Global geo IoU + per-class IoU + frequency-weighted mean IoU
    (test_scene_as_chunks.py:252-264, 308-319)."""
    with timing.span("serve.iou"):
        geo_iou = geo_i / geo_u if geo_u > 0 else float("nan")
        with np.errstate(invalid="ignore", divide="ignore"):
            iou_classes = cls_i / cls_u
        clean = np.nan_to_num(iou_classes, nan=0.0)
        mean_iou = float((clean * cls_w / max(cls_w.sum(), 1)).sum())
        return {
            "geo_iou": float(geo_iou),
            "class_iou": {class_names[i]: float(iou_classes[i]) for i in range(len(cls_i))},
            "mean_iou": mean_iou,
        }


def write_iou_txt(path: str, summary: Dict, class_names=category.CLASS_NAMES) -> None:
    """IoU.txt in the reference's format (test_scene_as_chunks.py:321-328)."""
    with open(path, "w") as f:
        f.write(str(summary["geo_iou"]))
        f.write("\n")
        if summary.get("class_iou"):
            for n in class_names:
                f.write(f"{n}\n")
            for n in class_names:
                f.write("%.3f\n" % np.nan_to_num(summary["class_iou"][n], nan=0.0))
            f.write("Mean: ")
            f.write(str(summary["mean_iou"]))

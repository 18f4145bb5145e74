"""Plain chunked scene completion of the reference (reference
torch/test_scene_as_chunks.py:92-330, as the port's ``inference/chunked.py``
computes it): the raw scene assembled and padded (a frozen copy of
``prep_compact_scene``), the windows at the stride, the plain generator in eval
mode a batch of windows at a time, the stitcher's sums and counts with its pad
border, the normalisation and the IoU accumulators (frozen copies of
``_Stitcher`` and ``summarize_iou``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import category, colorspace


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
            self.tgt = torch.from_numpy(np.pad(tgt, pad3, constant_values=np.inf)).to(device)
            self.kn = torch.from_numpy(np.pad(kn, pad3, constant_values=True)).to(device)
            self.sm = torch.from_numpy(
                np.pad(sm, pad3, constant_values=category.UNLABELED)).to(device)

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
        return {k: v.cpu().numpy() for k, v in out.items()}


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

def run_chunked(generator, raw_sdf, raw_rgb, target_sdf, known, target_semantics,
                truncation=3.0, chunk_dims=(128, 64, 64), stride=32, pad=2, max_height=128,
                window_batch=8, color_space="lab", device="cuda") -> SceneOutputs:
    """The scene's stitched outputs and IoU sums from the raw scene (``sdf``
    (Z,Y,X) float, ``rgb`` (Z,Y,X,3) uint8), every window predicted, colour and
    semantics on."""
    if max_height > 0 and raw_sdf.shape[0] > max_height:
        raw_sdf, raw_rgb = raw_sdf[:max_height], raw_rgb[:max_height]
        target_sdf, known = target_sdf[:max_height], known[:max_height]
        target_semantics = target_semantics[:max_height]
    cz, cy, cx = chunk_dims
    Z, Y, X = (int(d) for d in raw_sdf.shape[:3])
    positions = [(int(y), int(x)) for y, x in window_positions((Y, X), stride)]
    scene_in, scene_mask = prep_compact_scene(
        torch.from_numpy(np.ascontiguousarray(raw_sdf, dtype=np.float32)).to(device),
        torch.from_numpy(np.ascontiguousarray(raw_rgb)).to(device), float(truncation),
        color_space == "lab", (max(0, cz - Z), cy, cx))
    st = _Stitcher((Z, Y, X), chunk_dims, stride, pad, truncation, True, True, target_sdf,
                   known, target_semantics, device)
    generator.eval()
    with torch.no_grad():
        for start in range(0, len(positions), window_batch):
            pos = positions[start:start + window_batch]
            n_real = len(pos)
            cb = torch.stack([scene_in[:cz, y:y + cy, x:x + cx] for y, x in pos])
            mb = torch.stack([scene_mask[:cz, y:y + cy, x:x + cx] for y, x in pos])
            st.update(*generator(cb, mb, pred_color=True, pred_semantic=True), pos, n_real)
    return _outputs(st.finalize(), True, True)

"""Semantic dataset extension: splat labeled surface points into voxel grids
(rebuild of reference torch/extend_sdfs.py:81-155 and
torch/extend_sdfs_2cm.py:34-105).

The labeling strategy is the reference's two-pass splat: a dense pass writes
the label into the full floor-cube (8 corners) around each sampled point, a
second pass overwrites with the exact rounded point positions; everything
else stays UNLABELED (14)."""

from __future__ import annotations

import os
import shutil
import struct
from typing import Optional

import numpy as np

from ..data import category, formats

UNLABELED = category.UNLABELED


def splat_semantics(
    points_world: np.ndarray,  # (N, 3)
    labels: np.ndarray,  # (N,) int, already mapped to class ids (>=14 = drop)
    world2grid: np.ndarray,
    dims_zyx,
) -> np.ndarray:
    """Points -> dense (Z, Y, X) uint8 label grid (reference
    add_semantics_to_chunk_sdf, extend_sdfs.py:81-115)."""
    dimz, dimy, dimx = dims_zyx
    h = np.concatenate([points_world, np.ones((len(points_world), 1))], 1)
    x = (h @ np.asarray(world2grid, np.float64).T)[:, :3]  # xyz grid coords

    def in_bounds(p):
        return np.all(p >= 0, axis=1) & (p[:, 0] < dimx) & (p[:, 1] < dimy) & (p[:, 2] < dimz)

    dense = np.full((dimz, dimy, dimx), UNLABELED, np.uint8)
    # pass 1: floor-cube splat, labeled classes only
    cube = np.array(
        [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1], [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]]
    )
    xf = np.floor(x)
    pts = (cube[None, :, :] + xf[:, None, :]).reshape(-1, 3)
    lab = np.repeat(labels, 8)
    m = in_bounds(pts) & (lab < 14)
    pts = pts[m].astype(int)
    lab = lab[m]
    dense[pts[:, 2], pts[:, 1], pts[:, 0]] = lab
    # pass 2: exact rounded points override
    xr = np.rint(x)
    m = in_bounds(xr)
    pr = xr[m].astype(int)
    lr = labels[m].astype(np.uint8)
    keep = lr < 14
    dense[pr[keep, 2], pr[keep, 1], pr[keep, 0]] = lr[keep]
    return dense


def extend_sdf_file(
    sdf_file: str,
    output_path: str,
    points_world: np.ndarray,
    labels: np.ndarray,
    margin: float = 0.3,
) -> None:
    """Append dense semantics to a copy of a chunk .sdf, producing a
    ``__sem__`` file (reference extend_sdf_file, extend_sdfs.py:133-155)."""
    data = formats.load_sdf(sdf_file)
    dims = data.dims
    grid2world = np.linalg.inv(data.world2grid)
    corners = np.array(
        [[0, 0, 0, 1], [dims[2], dims[1], dims[0], 1]], np.float64
    )
    limits = (corners @ grid2world.T)[:, :3]
    lo = np.minimum(limits[0], limits[1]) - margin
    hi = np.maximum(limits[0], limits[1]) + margin
    sel = np.all((points_world >= lo) & (points_world <= hi), axis=1)
    dense = splat_semantics(points_world[sel], labels[sel], data.world2grid, dims)
    shutil.copyfile(sdf_file, output_path)
    with open(output_path, "ab") as f:
        f.write(struct.pack("<Q", dense.size))
        f.write(dense.tobytes())


def write_scene_semantics(
    sdf_file: str,
    output_semantics_path: str,
    points_world: np.ndarray,
    labels: np.ndarray,
) -> None:
    """Standalone .semantics for full 2 cm scenes (reference
    extend_sdfs_2cm.py:34-105: label 41 (mpcat40 unlabeled) maps to 14)."""
    data = formats.load_sdf(sdf_file)
    labels = np.where(labels == 41, UNLABELED, labels)
    dense = splat_semantics(points_world, labels, data.world2grid, data.dims)
    formats.save_semantics(output_semantics_path, dense)


def read_labeled_ply(path: str):
    """Read a Matterport region-segmentation PLY: vertices + faces with a
    per-face ``category_id`` property (reference sample_util.py:45-67 via
    plyfile). Binary little-endian only. Returns (verts (N,3) float32,
    faces (M,3) int64, face_category (M,) int64)."""
    import struct as _struct

    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts = n_faces = 0
        elem = None
        vprops = []
        fprops = []  # non-list face properties after the vertex_indices list
        tmap = {"float": ("<f4", 4), "float32": ("<f4", 4), "double": ("<f8", 8),
                "uchar": ("u1", 1), "uint8": ("u1", 1), "char": ("i1", 1),
                "int": ("<i4", 4), "int32": ("<i4", 4), "uint": ("<u4", 4),
                "short": ("<i2", 2), "ushort": ("<u2", 2)}
        for l in header:
            t = l.split()
            if t[0] == "element":
                elem = t[1]
                if elem == "vertex":
                    n_verts = int(t[2])
                elif elem == "face":
                    n_faces = int(t[2])
            elif t[0] == "property":
                if elem == "vertex" and t[1] != "list":
                    vprops.append((t[2], tmap[t[1]][0]))
                elif elem == "face":
                    if t[1] == "list":
                        fprops.append(("__list__", tmap[t[2]][0], tmap[t[3]][0]))
                    else:
                        fprops.append((t[2], tmap[t[1]][0]))
        vdt = np.dtype([(n, d) for n, d in vprops])
        vdata = np.frombuffer(f.read(n_verts * vdt.itemsize), dtype=vdt)
        verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], 1).astype(np.float32)
        faces = np.zeros((n_faces, 3), np.int64)
        cats = np.zeros(n_faces, np.int64)
        for i in range(n_faces):
            for prop in fprops:
                if prop[0] == "__list__":
                    cnt_dt, idx_dt = np.dtype(prop[1]), np.dtype(prop[2])
                    cnt = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                    idx = np.frombuffer(f.read(idx_dt.itemsize * cnt), idx_dt)
                    faces[i] = idx[:3]
                else:
                    dt = np.dtype(prop[1])
                    val = np.frombuffer(f.read(dt.itemsize), dt)[0]
                    if prop[0] == "category_id":
                        cats[i] = int(val)
    return verts, faces, cats


def sample_labeled_mesh(verts, faces, face_category, samples_per_face: int = 4, seed: int = 0):
    """Barycentric samples with the owning face's category id (reference
    sample_util.sample_point_cloud with per-face category, :5-42).
    Returns (points (K,3), categories (K,))."""
    rng = np.random.default_rng(seed)
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = max(areas.sum(), 1e-12)
    n = samples_per_face * len(faces)
    fidx = rng.choice(len(faces), size=n, p=areas / total)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    a = 1.0 - r1
    b = r1 * (1.0 - r2)
    c = r1 * r2
    pts = a[:, None] * v0[fidx] + b[:, None] * v1[fidx] + c[:, None] * v2[fidx]
    return pts.astype(np.float32), face_category[fidx]


def labels_from_category_mapping(
    raw_categories: np.ndarray, mapping_tsv: str, column: str = "eigen13id"
) -> np.ndarray:
    """Map raw Matterport category ids to eigen13 ids via the
    category_mapping.tsv table (reference extend_sdfs.py:180-191)."""
    import pandas as pd

    table = pd.read_csv(mapping_tsv, sep="\t")
    lut = np.full(int(table["index"].max()) + 2, UNLABELED, np.int64)
    lut[table["index"].to_numpy()] = table[column].fillna(UNLABELED).to_numpy().astype(np.int64)
    raw = np.clip(raw_categories.astype(np.int64), 0, len(lut) - 1)
    return lut[raw]


# ---------------------------------------------------------------------------
# raw Matterport3D semantics ingestion (.semseg.json + .vsegs.json)
# ---------------------------------------------------------------------------


def read_vsegs_json(path: str) -> np.ndarray:
    """Per-vertex segment ids from a Matterport ``.vsegs.json``
    (reference datagen/src/Segmentation.h:60-86: the ``segIndices`` array,
    one entry per mesh vertex)."""
    import json

    with open(path) as f:
        data = json.load(f)
    return np.asarray(data["segIndices"], np.int64)


def read_semseg_json(path: str):
    """Segment-id -> raw label-string map from a Matterport ``.semseg.json``
    (reference datagen/src/Aggregation.h:47-80: ``segGroups`` entries carry a
    ``label`` and the ``segments`` ids belonging to that object)."""
    import json

    with open(path) as f:
        data = json.load(f)
    seg_to_label = {}
    for group in data["segGroups"]:
        label = group.get("label", "")
        for seg in group.get("segments", []):
            seg_to_label[int(seg)] = label
    return seg_to_label


def label_ids_from_names(names, mapping_tsv: str, name_column: str = "raw_category",
                         id_column: str = "eigen13id") -> np.ndarray:
    """Label strings -> class ids via category_mapping.tsv (reference
    datagen/src/LabelUtil.h:3-89 maps labelName -> idName columns)."""
    import pandas as pd

    table = pd.read_csv(mapping_tsv, sep="\t")
    lut = {
        str(n): (UNLABELED if pd.isna(i) else int(i))
        for n, i in zip(table[name_column], table[id_column])
    }
    return np.asarray([lut.get(str(n), UNLABELED) for n in names], np.int64)


def vertex_labels_from_segmentation(
    vsegs_path: str, semseg_path: str, mapping_tsv: str,
    name_column: str = "raw_category", id_column: str = "eigen13id",
) -> np.ndarray:
    """Per-vertex class ids from the raw Matterport annotation pair
    (the pipeline Scene::computeObjectIdsAndColorsPerVertex implements in
    C++, datagen/src/Scene.cpp:127-166): vertex -> segment (.vsegs.json) ->
    object label (.semseg.json) -> class id (category_mapping.tsv)."""
    vsegs = read_vsegs_json(vsegs_path)
    seg_to_label = read_semseg_json(semseg_path)
    seg_ids = np.asarray(sorted(set(seg_to_label)), np.int64)
    seg_names = [seg_to_label[int(s)] for s in seg_ids]
    seg_label_ids = label_ids_from_names(seg_names, mapping_tsv, name_column, id_column)
    lut_size = int(max(vsegs.max(initial=0), seg_ids.max(initial=0))) + 2
    lut = np.full(lut_size, UNLABELED, np.int64)
    lut[seg_ids] = seg_label_ids
    # negative segment ids mark unsegmented vertices -> UNLABELED (the last
    # lut slot is never a real segment and stays UNLABELED)
    idx = np.where(vsegs < 0, lut_size - 1, np.clip(vsegs, 0, lut_size - 1))
    return lut[idx]


def face_labels_from_vertex_labels(faces: np.ndarray, vertex_labels: np.ndarray) -> np.ndarray:
    """Majority vote of the 3 corner labels per face (ties -> first corner),
    feeding the existing per-face sampling path (sample_labeled_mesh)."""
    a = vertex_labels[faces[:, 0]]
    b = vertex_labels[faces[:, 1]]
    c = vertex_labels[faces[:, 2]]
    out = a.copy()
    bc = (b == c) & (a != b)
    out[bc] = b[bc]
    return out

"""The format of the golden files that ``tools/export_torch_goldens.py``
writes from a checkpoint trained with the JAX package, and that the port's
checks read: which arrays a chunk's frame and marches are, how each is
hashed, and the manifest that names every file by its sha256. Both sides
import it, so a file hashed on one side is hashed the same on the other."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

# a chunk's frame: depth, colour and camera, as both packages lay it out
FRAME_KEYS = ("images_depth", "images_color", "images_view", "images_intrinsic")
# the two marches of precompute_views (input grid, projected target grid)
MARCH_KEYS = ("in_hit", "in_hit_idx", "in_depth", "tgt_hit", "tgt_hit_idx", "tgt_depth")
# the marches' keys a golden holds by sha256: hits and their voxels (a depth
# is held by its values, a march patch's tolerance)
MARCH_DIGEST_KEYS = tuple(k for k in MARCH_KEYS if "depth" not in k)


# how far a view may lie from the JAX value at an index of a chunk's
# march_patches, relative to max(1, |value|): tools/export_torch_goldens.py's
# PATCH_TOL, the tolerance that decided which indices the golden records (a
# hit or its voxel must be equal)
PATCH_TOL = {"in_depth": 1e-6, "tgt_depth": 1e-6, "images_normals": 1e-4}


def patches_not_held(views: dict, patches: dict) -> dict:
    """Per key of a chunk's ``march_patches`` (golden_val.json: flat indices
    and the JAX package's values there), the number of those indices at which
    ``views`` (numpy arrays, the port's precompute_views) does not hold the
    JAX value: a hit or voxel not equal, a depth or normal beyond PATCH_TOL,
    or NaN on one side only."""
    out = {}
    for k, (idx, vals) in patches.items():
        got = np.asarray(views[k]).reshape(-1)[np.asarray(idx, dtype=np.int64)]
        want = np.asarray(vals, dtype=np.float64)
        if got.dtype.kind == "f":
            got = got.astype(np.float64)
            off = (np.abs(got - want) > PATCH_TOL[k] * np.maximum(1.0, np.abs(want))) | (
                np.isnan(got) != np.isnan(want))
        else:
            off = got.astype(np.float64) != want
        out[k] = int(off.sum())
    return out


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def array_digest(a) -> str:
    """sha256 of a numpy array's bytes, in C order."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def frame_digest(sample: dict) -> str:
    """sha256 of a chunk's frame (FRAME_KEYS, as float32)."""
    h = hashlib.sha256()
    for k in FRAME_KEYS:
        h.update(np.ascontiguousarray(sample[k], np.float32).tobytes())
    return h.hexdigest()


def manifest_files(directory: str) -> dict:
    """sha256 and size of each file of ``directory`` but MANIFEST.json."""
    return {f: dict(sha256=sha256_file(os.path.join(directory, f)),
                    bytes=os.path.getsize(os.path.join(directory, f)))
            for f in sorted(os.listdir(directory)) if f != "MANIFEST.json"}


def check_manifest(directory: str) -> dict:
    """``directory``'s MANIFEST.json, after each file it names is checked
    against its sha256 (ValueError if one is not)."""
    with open(os.path.join(directory, "MANIFEST.json")) as f:
        manifest = json.load(f)
    for name, entry in manifest["files"].items():
        if sha256_file(os.path.join(directory, name)) != entry["sha256"]:
            raise ValueError(f"{name} is not the file MANIFEST.json names")
    return manifest


def replay_args(parser, raw: dict):
    """The namespace of a train CLI's ``parser`` with every flag of ``raw``
    (a run's args.txt) that the parser knows set to the run's value."""
    ns = parser.parse_args([])
    for k, v in raw.items():
        if hasattr(ns, k):
            setattr(ns, k, v)
    return ns

"""Class constants of the reference: a frozen copy of ``spsg_tpu_torch/data/category.py``'s
names and cross-entropy weights."""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 14
UNLABELED = 14

CLASS_NAMES = (
    "void",
    "Bed",
    "Books",
    "Ceiling",
    "Chair",
    "Floor",
    "Furniture",
    "Objects",
    "Picture",
    "Sofa",
    "Table",
    "TV",
    "Wall",
    "Window",
)

# (NUM_CLASSES + 1, 3) uint8: per-class visualization color; last = unlabeled.
MAPPING_COLOR = np.array(
    [
        [255, 255, 255],
        [174, 199, 232],
        [255, 127, 14],
        [255, 187, 120],
        [44, 160, 44],
        [152, 223, 138],
        [214, 39, 40],
        [255, 152, 150],
        [148, 103, 189],
        [197, 176, 213],
        [140, 86, 75],
        [196, 156, 148],
        [227, 119, 194],
        [247, 182, 210],
        [0, 0, 0],
    ],
    dtype=np.uint8,
)

# Inverse-frequency cross-entropy class weights from Matterport3D train split.
CLASS_WEIGHTS = np.array(
    [
        0.02858732,
        0.15351124,
        0.29859809,
        0.01774922,
        0.01661129,
        0.02006971,
        0.01173498,
        0.00325102,
        0.01880572,
        0.13640693,
        0.03837781,
        0.23887847,
        0.0037623,
        0.01365591,
    ],
    dtype=np.float64,
)

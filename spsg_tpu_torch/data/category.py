"""Semantic class metadata (eigen13-derived, 14 classes + unlabeled).

Dataset metadata replicated from the reference's ``category.npz`` artifact
(generated by torch/extend_sdfs.py:194-200 from Matterport3D label statistics;
loaded at torch/train.py:118-119 and torch/test_scene_as_chunks.py:70-71).

Class ids: 0..13 are the trainable classes below; 14 means "unlabeled" and is
excluded from losses/metrics. ``MAPPING_COLOR`` row 0 (void) is white, rows
1..13 are tab20 colors, row 14 (unlabeled) is black.
"""

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


def save_category_npz(path: str, class_counts: np.ndarray | None = None) -> None:
    """Regenerate a ``category.npz`` artifact. If per-class voxel counts are
    given, weights are recomputed as normalized inverse frequencies
    (reference torch/extend_sdfs.py:194-200); otherwise the stock weights
    are written."""
    if class_counts is not None:
        inv = 1.0 / np.maximum(np.asarray(class_counts, dtype=np.float64), 1.0)
        weight = inv / inv.sum()
    else:
        weight = CLASS_WEIGHTS
    np.savez(
        path,
        mapping_color=MAPPING_COLOR,
        class_name=np.array(CLASS_NAMES),
        weight=weight,
    )


def load_category_npz(path: str):
    d = np.load(path)
    return d["mapping_color"], d["class_name"], d["weight"].flatten()


def save_legend_png(path: str) -> None:
    """Class legend figure (reference extend_sdfs.py plot_colortable ->
    Category_list.png)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    n = NUM_CLASSES
    fig, ax = plt.subplots(figsize=(4, n * 0.35))
    ax.set_xlim(0, 10)
    ax.set_ylim(0, n)
    ax.axis("off")
    for i in range(n):
        y = n - 1 - i
        ax.add_patch(
            Rectangle((0, y + 0.1), 2, 0.8, facecolor=MAPPING_COLOR[i] / 255.0, edgecolor="0.7")
        )
        ax.text(2.3, y + 0.5, CLASS_NAMES[i], va="center", fontsize=10)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def map_label_to_color(semantics: np.ndarray, mapping_color: np.ndarray = MAPPING_COLOR):
    """Label grid (...,) -> RGB uint8 grid (..., 3)
    (reference torch/data_util.py:579-584)."""
    sem = np.clip(semantics.astype(np.int64), 0, len(mapping_color) - 1)
    return mapping_color[sem]

"""Single-shot whole-scene inference (PyTorch counterpart of
``spsg_tpu/inference/whole_scene.py``; reference torch/test_scene.py:103-171).

The generator is fully convolutional, so one forward over the padded scene
replaces the sliding windows of ``inference/chunked.py``: the 3x3x3 convs run
on the hand kernels at the scene's shape, e.g. (1, 128, 160, 192) voxels.

With ``mesh=`` (``parallel.make_mesh()``, one process a device) the scene
shards spatially: Y is padded to a multiple of ``4 * ranks``, each rank holds
one Y-slab in rank order, every conv exchanges halo rows with the neighbouring
slabs (``models/generator.py::ConvBlock``, the halos GSPMD inserts in the JAX
package), and the slabs' outputs are gathered on every rank."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..training.state import resolve_device


def pad_scene(
    inputs: np.ndarray,  # (Z, Y, X, C)
    mask: np.ndarray,
    truncation: float,
    max_height: int = 128,
    multiple: int = 4,
    y_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int, int]]:
    """Crop height + pad dims to multiples (reference test_scene.py:120-140).
    ``y_multiple`` additionally rounds Y up so it divides the mesh axis."""
    h = min(max_height, inputs.shape[0]) if max_height else inputs.shape[0]
    dims = np.array([h, inputs.shape[1], inputs.shape[2]])
    dims = ((dims + multiple - 1) // multiple) * multiple
    m = max(multiple, y_multiple)
    dims[1] = ((dims[1] + m - 1) // m) * m
    out = np.zeros(tuple(dims) + (inputs.shape[-1],), np.float32)
    out[..., 0] = -truncation
    out[:h, : inputs.shape[1], : inputs.shape[2]] = inputs[:h]
    mout = np.zeros(tuple(dims) + (1,), np.float32)
    mout[:h, : mask.shape[1], : mask.shape[2]] = mask[:h]
    return out, mout, tuple(int(d) for d in dims)


def run_whole_scene(
    generator,
    scene_input: np.ndarray,  # (Z, Y, X, 4)
    scene_mask: np.ndarray,  # (Z, Y, X, 1)
    truncation: float = 3.0,
    max_height: int = 128,
    pred_color: bool = True,
    pred_semantic: bool = True,
    mesh=None,
    device="cuda",
):
    """One eval-mode forward of ``generator`` (a ``models.Generator``, moved
    to ``device``) under ``torch.no_grad()`` over the padded scene. ``device``
    defaults to the GPU and raises if there is none; pass ``"cpu"`` to run on
    the CPU. Returns (occ_logits (Z,Y,X), sdf, color (Z,Y,X,3) or None,
    semantics (Z,Y,X,14) or None) as float32 numpy arrays of the padded
    scene's shape. ``mesh`` (``parallel.Mesh``): every rank calls this with
    the same arguments and gets the whole result; the padded Y is a multiple
    of ``4 * ranks``, as in the JAX package."""
    mesh = pmesh.check_mesh(mesh)
    sharded = pmesh.active(mesh)
    n_shards = mesh.size if mesh is not None else 1
    device = resolve_device(device)
    inp, msk, dims = pad_scene(scene_input, scene_mask, truncation, max_height,
                               y_multiple=4 * n_shards)
    if sharded:  # this rank's Y-slab
        rows = slice(mesh.rank * dims[1] // n_shards, (mesh.rank + 1) * dims[1] // n_shards)
        inp, msk = inp[:, rows], msk[:, rows]
    x = torch.from_numpy(np.ascontiguousarray(inp[None])).to(device)
    m = torch.from_numpy(np.ascontiguousarray(msk[None])).to(device)
    generator = generator.to(device)
    was_training = generator.training
    generator.eval()
    try:
        with torch.no_grad():
            occ_l, sdf, color, sem = generator(
                x, m, pred_color=pred_color, pred_sdf=True, pred_semantic=pred_semantic,
                mesh=mesh, spatial=sharded)
            if sharded:
                occ_l, sdf, color, sem = (None if o is None else pmesh.gather(o, mesh, dim=2)
                                          for o in (occ_l, sdf, color, sem))
    finally:
        generator.train(was_training)
    return (
        occ_l[0, ..., 0].cpu().numpy(),
        sdf[0, ..., 0].cpu().numpy(),
        color[0].cpu().numpy() if color is not None else None,
        sem[0].cpu().numpy() if sem is not None else None,
    )

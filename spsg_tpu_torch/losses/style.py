"""VGG style / content losses (PyTorch counterpart of
``spsg_tpu/losses/style.py``; reference torch/style.py:18-68).

Feature maps come from :mod:`spsg_tpu_torch.models.vgg`, channel-last. The
Gram product is ``torch.matmul``, the JAX package's ``f @ f.T``: on a card it
runs in true float32 once ``models/generator.py::use_true_float32`` is in
force (the trainer's device set-up turns it on), not in TF32.

With ``mesh`` (data-parallel training) the losses are the global batch's: the
content loss's mean is global, and the Gram matrices are of the stacked global
batch, whose features every rank gathers (``parallel/mesh.py::gather_rows``:
the gradient reaches each rank's own rows)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..parallel.mesh import gather_rows, global_mean


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the Gram matrix of the stacked (B*C, H*W) feature
    matrix, divided by C*H*W (reference style.py:18-22: the batch is stacked
    into the feature dimension, so the result is (B*C, B*C))."""
    b, h, w, c = features.shape
    f = features.permute(0, 3, 1, 2).reshape(b * c, h * w)
    return (f @ f.T) / (c * h * w)


def style_content_loss(
    output_features: Sequence[torch.Tensor],
    target_features: Sequence[torch.Tensor],
    compute_style: bool,
    compute_content: bool,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(style, content): the MSE of the 10x scaled Gram matrices and the MSE
    of the features, summed over the layers (reference style.py:36-50)."""
    device = output_features[0].device
    loss_style = torch.zeros((), device=device)
    loss_content = torch.zeros((), device=device)
    for out_f, tgt_f in zip(output_features, target_features):
        if compute_content:
            loss_content = loss_content + global_mean((out_f - tgt_f) ** 2, mesh)
        if compute_style:
            g_out = gram_matrix(gather_rows(out_f, mesh)) * 10.0
            g_tgt = gram_matrix(gather_rows(tgt_f, mesh)) * 10.0
            loss_style = loss_style + torch.mean((g_out - g_tgt) ** 2)
    return loss_style, loss_content

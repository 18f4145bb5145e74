"""GAN losses: vanilla / hinge / wgan / wgan-gp (PyTorch counterpart of
``spsg_tpu/losses/gan.py``; reference torch/loss.py:359-472).

The discriminator gives patch logits (B, H', W', 1); every variant is a
masked mean with optional per-patch weights and per-sample weights
(--weight_by_percent_pixels, train.py:705-715). With ``mesh`` every mean is
over the global batch (``losses/geo.py``)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ._single import global_mean
from .losses_geo import masked_mean


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    return torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def _masked(x: torch.Tensor, valid: Optional[torch.Tensor],
            sample_weight: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    """x (B,H,W,1); valid (B,H,W) or None; sample_weight (B,) or None."""
    x = x.mean(dim=-1)
    if sample_weight is not None:
        x = x * sample_weight[:, None, None]
    if valid is None:
        return global_mean(x, mesh)
    return masked_mean(x, valid, mesh=mesh)


def discriminator_loss(
    loss_type: str,
    d_real: torch.Tensor,
    d_fake: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    weight: Optional[torch.Tensor] = None,
    label_smoothing: float = 1.0,
    sample_weight_real: Optional[torch.Tensor] = None,
    sample_weight_fake: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real_loss, fake_loss) scalars (reference loss.py:374-442)."""
    if weight is not None:
        d_real = d_real * weight.reshape(d_real.shape)
        d_fake = d_fake * weight.reshape(d_fake.shape)
    if loss_type == "vanilla":
        real = _bce_logits(d_real, label_smoothing)
        fake = _bce_logits(d_fake, 0.0)
    elif loss_type == "hinge":
        real = torch.relu(1.0 - d_real)
        fake = torch.relu(1.0 + d_fake)
    elif loss_type in ("wgan", "wgan_gp"):
        real = -d_real
        fake = d_fake
    else:
        raise ValueError(loss_type)
    return (_masked(real, valid, sample_weight_real, mesh),
            _masked(fake, valid, sample_weight_fake, mesh))


def generator_loss(loss_type: str, d_fake: torch.Tensor, mesh=None) -> torch.Tensor:
    """Generator adversarial loss, an unmasked mean as in the reference
    (loss.py:393-401)."""
    if loss_type == "vanilla":
        return global_mean(_bce_logits(d_fake, 1.0), mesh)
    return -global_mean(d_fake, mesh)


def gradient_penalty(
    disc_apply: Callable[[torch.Tensor], torch.Tensor],
    in_real: torch.Tensor,
    in_fake: torch.Tensor,
    alpha: torch.Tensor,
    mesh=None,
) -> torch.Tensor:
    """WGAN-GP penalty on interpolated inputs (reference loss.py:444-472).
    ``alpha`` (B, 1, ..., 1) comes from the caller (the JAX package draws it
    inside from a key), so that a test can hand both packages the same draw.
    Differentiable in the discriminator's parameters (double backward)."""
    b = in_real.shape[0]
    interp = (alpha * in_real + (1.0 - alpha) * in_fake).detach().requires_grad_(True)
    score = disc_apply(interp).sum()
    (grads,) = torch.autograd.grad(score, interp, create_graph=True)
    gnorm = torch.sqrt((grads.reshape(b, -1) ** 2).sum(dim=1) + 1e-12)
    return global_mean((gnorm - 1.0) ** 2, mesh)

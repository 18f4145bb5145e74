"""2D spectral-norm patch discriminator (PyTorch counterpart of
``spsg_tpu/models/discriminator.py``; reference torch/model.py:19-104).

Works on rendered (colour + normal) image stacks, channel-last (B, H, W, C) at
its public functions. The depth comes from the patch size against approximate
receptive-field sizes (model.py:44-56); each layer is a spectral-normalised
4x4 stride-2 conv with LeakyReLU(0.2) (none after the last), then an optional
1x1 ``final`` conv (absent for patch + hinge). The 2D convs are
``F.conv2d``: the JAX package leaves them to XLA, not to Pallas.

Spectral normalisation is the one of Flax's ``nn.SpectralNorm`` that the JAX
package uses, not ``torch.nn.utils.spectral_norm`` (which skips the power
iteration in eval mode and updates ``u`` on every train-mode forward): every
call runs one power iteration from the *stored* ``u`` of each conv,
``v = l2n(u W^T)``, ``u' = l2n(v W)`` with ``l2n(x) = x * rsqrt(sum x^2 +
1e-12)``, ``sigma = v W u'^T`` (u', v without gradient) and divides the
kernel, not the bias, by sigma (when it is not 0); W is the kernel as the
(kh*kw*Cin, Cout) matrix of the JAX layout. The stored ``u`` and ``sigma``
are an explicit state (:class:`SpectralState`, a dict) that a call takes and,
with ``update_sn_stats``, returns updated: the train step threads it through
its four calls in a fixed order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

APPROX_RECEPTIVE_FIELD_SIZES = (4, 10, 22, 46, 94, 190, 382, 766)

# {"sn_conv_<k>": {"u": (1, Cout), "sigma": ()}}
SpectralState = Dict[str, Dict[str, torch.Tensor]]


def num_disc_layers(patch_size: int, image_dims, patch: bool) -> int:
    """Layer-count rule of reference model.py:44-56. image_dims = (H, W)."""
    num_layers = len(APPROX_RECEPTIVE_FIELD_SIZES)
    if patch:
        for k, rf in enumerate(APPROX_RECEPTIVE_FIELD_SIZES):
            if patch_size < rf:
                num_layers = k
                break
    dim = min(image_dims[0], image_dims[1])
    num_layers = min(int(math.floor(math.log2(dim))), num_layers)
    assert num_layers >= 1
    return num_layers


def leaky_relu(x):
    """LeakyReLU(0.2) with slope 1 at exactly 0, as ``jax.nn.leaky_relu``."""
    return torch.where(x >= 0, x, 0.2 * x)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor):
    """One power iteration from ``u`` (1, Cout) on the conv weight (Cout, Cin,
    kh, kw). Returns (weight / sigma, new u, sigma); sigma and the division
    carry the gradient to ``weight``, u and v do not."""
    mat = weight.permute(2, 3, 1, 0).reshape(-1, weight.shape[0])  # the JAX layout
    with torch.no_grad():
        v0 = _l2_normalize(u @ mat.t())
        u0 = _l2_normalize(v0 @ mat)
    sigma = ((v0 @ mat) @ u0.t())[0, 0]
    w = weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
    return w, u0, sigma


class Discriminator2D(nn.Module):
    def __init__(self, nf_in: int = 12, nf: int = 8, patch_size: int = 96,
                 image_dims: Sequence[int] = (256, 320), patch: bool = True,
                 disc_loss_type: str = "vanilla"):
        super().__init__()
        self.patch = patch
        n = num_disc_layers(patch_size, image_dims, patch)
        widths = [2 * nf, 4 * nf] + [8 * nf] * max(0, n - 2)
        self.n_layers = n
        cins = [nf_in] + widths[:n - 1]
        self.convs = nn.ModuleList(
            nn.Conv2d(cins[k], widths[k], 4, 2, 1) for k in range(n))
        self.final = (None if (patch and disc_loss_type == "hinge")
                      else nn.Conv2d(widths[n - 1], 1, 1))

    def forward(self, x: torch.Tensor, sn_state: SpectralState,
                update_sn_stats: bool = False) -> Tuple[torch.Tensor, SpectralState]:
        """x (B, H, W, nf_in) -> (patch logits (B, H', W', 1), spectral state):
        the updated state with ``update_sn_stats``, else ``sn_state`` itself."""
        y = x.permute(0, 3, 1, 2)
        new_state = {} if update_sn_stats else sn_state
        for k, conv in enumerate(self.convs):
            name = f"sn_conv_{k}"
            w, u, sigma = spectral_normalize(conv.weight, sn_state[name]["u"])
            if update_sn_stats:
                new_state[name] = {"u": u, "sigma": sigma.detach()}
            y = F.conv2d(y, w, conv.bias, stride=2, padding=1)
            if k < self.n_layers - 1:
                y = leaky_relu(y)
        if self.final is not None:
            y = self.final(y)
        return y.permute(0, 2, 3, 1), new_state

    def compute_valids(self, valid: torch.Tensor) -> Optional[torch.Tensor]:
        """Map a (B, H, W, 1) pixel-validity mask to patch validity through the
        AvgPool(4, stride 2, pad 1) pyramid (reference model.py:82-94)."""
        if not self.patch:
            return None
        v = valid.permute(0, 3, 1, 2)
        for _ in range(self.n_layers):
            v = F.avg_pool2d(v, 4, 2, 1, count_include_pad=True)
        return v.permute(0, 2, 3, 1)


def init_spectral_state(disc: Discriminator2D, generator: torch.Generator) -> SpectralState:
    """Fresh spectral state: ``u`` ~ N(0, 1), ``sigma`` = 1, as Flax
    initialises them (from the CPU ``generator``)."""
    dev = disc.convs[0].weight.device
    return {f"sn_conv_{k}": {"u": torch.randn((1, c.out_channels), generator=generator).to(dev),
                             "sigma": torch.ones((), device=dev)}
            for k, c in enumerate(disc.convs)}

"""Generator and discriminator construction, initialisation, optimizers and
generator checkpoints (PyTorch counterpart of ``spsg_tpu/training/state.py``).
Checkpoints of the discriminator come with the training loop (ROADMAP.md)."""

from __future__ import annotations

import math
import os
from typing import Tuple

import torch

from ..models.discriminator import Discriminator2D, SpectralState, init_spectral_state
from ..models.generator import Generator, GeneratorConfig, use_true_float32
from .config import TrainConfig


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default everywhere)
    without a usable GPU raises: nothing falls back to the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spsg_tpu_torch: no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    return device


def make_generator(cfg: TrainConfig, device="cuda", plain_convs: bool = False) -> Generator:
    """The generator of ``cfg`` on ``device``. On a CUDA device this also turns
    TF32 off process-wide (see ``use_true_float32``)."""
    device = resolve_device(device)
    if device.type == "cuda":
        use_true_float32()
    gen = Generator(
        GeneratorConfig(
            nf=cfg.nf_gen,
            nf_in_color=4 if cfg.input_mask else 3,
            pass_geo_feats=cfg.pass_geo_feats,
            truncation=cfg.truncation,
            input_mask=cfg.input_mask,
            dtype=cfg.compute_dtype,
        ),
        plain_convs=plain_convs,
    )
    return gen.to(device)


def init_generator(cfg: TrainConfig, generator: torch.Generator, device="cuda",
                   plain_convs: bool = False) -> Generator:
    """A generator with freshly drawn parameters: conv weights
    U(+-sqrt(1/fan_in)) (torch Conv3d's kaiming_uniform(a=sqrt(5)), the JAX
    package's ``torch_kernel_init``), zero biases, identity BatchNorm. All
    randomness comes from the explicit CPU ``generator``."""
    gen = make_generator(cfg, device, plain_convs)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if p.dim() == 5:
                bound = 1.0 / math.sqrt(p[0].numel())
                w = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
                p.copy_(w.to(p.device))
    return gen


def gen_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """Adam with torch's defaults (b1 0.9, b2 0.999, eps 1e-8) and additive
    weight decay (reference train.py:156): the update the JAX package builds
    from ``add_decayed_weights`` followed by ``adam``.

    Adam skips a parameter whose ``.grad`` is None, decay included, and keeps a
    step count per parameter; the JAX package hands every parameter a gradient
    (zero where the loss did not reach it) and counts steps once. Callers
    therefore zero-fill missing gradients before ``step()`` (``Trainer.step``
    does)."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def make_discriminator(cfg: TrainConfig, device="cuda") -> Discriminator2D:
    """The discriminator of ``cfg`` on ``device`` (weights as ``nn.Conv2d``
    draws them; :func:`init_discriminator` draws them as the JAX package)."""
    device = resolve_device(device)
    return Discriminator2D(
        nf_in=cfg.disc_nf_in,
        nf=cfg.nf_disc,
        patch_size=cfg.patch_size,
        image_dims=(cfg.style_height, cfg.style_width),
        patch=cfg.patch_disc,
        disc_loss_type=cfg.disc_loss_type,
    ).to(device)


def init_discriminator(cfg: TrainConfig, generator: torch.Generator,
                       device="cuda") -> Tuple[Discriminator2D, SpectralState]:
    """A discriminator with freshly drawn parameters and its spectral state:
    conv weights U(+-sqrt(1/fan_in)) (``torch_kernel_init``), zero biases,
    ``u`` ~ N(0, 1), ``sigma`` = 1, all from the CPU ``generator``."""
    disc = make_discriminator(cfg, device)
    with torch.no_grad():
        for name, p in disc.named_parameters():
            if p.dim() == 4:
                bound = 1.0 / math.sqrt(p[0].numel())
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
                        .to(p.device))
            else:
                p.zero_()
    return disc, init_spectral_state(disc, generator)


def disc_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """Adam at ``d_lr_factor * lr`` (b1 0.9, b2 0.999, eps 1e-8) with additive
    weight decay, as :func:`gen_optimizer` (reference train.py:157-158)."""
    return torch.optim.Adam(params, lr=cfg.d_lr_factor * cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def save_checkpoint(path: str, gen: Generator, epoch: int) -> None:
    """``torch.save`` of ``{"epoch", "state_dict"}`` (tensors on the CPU)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in gen.state_dict().items()}
    torch.save({"epoch": int(epoch), "state_dict": sd}, path)


def load_checkpoint(path: str, gen: Generator) -> Tuple[Generator, int]:
    """Load a checkpoint written by :func:`save_checkpoint` (or by
    ``tools/export_torch_checkpoint.py``) into ``gen``. Returns
    ``(gen, epoch)``. Checkpoints of the original PyTorch reference (``.pth``)
    use other module names and are not read yet (ROADMAP.md)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
        raise ValueError(f"{path!r} is not a spsg_tpu_torch checkpoint ({{'epoch','state_dict'}})")
    if any(k.split(".")[1:2] and k.split(".")[1].isdigit() for k in ckpt["state_dict"]):
        raise NotImplementedError(
            f"{path!r} looks like a checkpoint of the original PyTorch reference; "
            "loading those is not ported yet (ROADMAP.md)"
        )
    gen.load_state_dict(ckpt["state_dict"], strict=True)
    return gen, int(ckpt.get("epoch", 0))

"""Generator and discriminator construction, initialisation, optimizers and
checkpoints (PyTorch counterpart of ``spsg_tpu/training/state.py``).

A checkpoint is one ``torch.save`` file (tensors on the CPU):
``{"epoch", "state_dict"}`` (the generator's parameters and BatchNorm
statistics) and, when it holds the whole training state, ``"optimizer"`` (the
generator's Adam: moments and per-parameter step counts) and, with a
discriminator, ``"disc_state_dict"``, ``"sn_state"`` (its spectral ``u`` /
``sigma``) and ``"disc_optimizer"``: what the JAX package's orbax checkpoint
holds in its ``GenState`` / ``DiscState``. Serving reads ``"state_dict"``
only. :func:`load_any_checkpoint` also reads the original PyTorch reference's
checkpoints (``.pth``), converting its module names.

In a process group (``parallel/multihost.py``) only the primary rank writes a
checkpoint; every rank reads one (the same file gives every rank the same
state, which ``parallel.replicate_state`` can then assert by broadcasting
rank 0's)."""

from __future__ import annotations

import math
import os
from typing import Tuple, Union

import torch

from ..models import convert
from ..models.discriminator import Discriminator2D, SpectralState, init_spectral_state
from ..models.generator import Generator, GeneratorConfig, use_true_float32
from ..parallel import multihost
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
            folded_conv=cfg.folded_conv,
            zslab_conv=cfg.zslab_conv,
            remat=cfg.remat,
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


def save_checkpoint(path: str, model: Union[Generator, "Trainer"], epoch: int) -> None:
    """``torch.save`` of a checkpoint (the module docstring's layout), tensors
    on the CPU. ``model`` is a ``Trainer`` (the whole training state, as the
    JAX package's ``save_checkpoint`` of both states) or a bare generator (its
    weights only). In a process group only the primary rank writes."""
    if not multihost.is_primary():
        return
    def cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu()
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree

    gen = model if isinstance(model, torch.nn.Module) else model.generator
    ckpt = {"epoch": int(epoch), "state_dict": cpu(gen.state_dict())}
    if not isinstance(model, torch.nn.Module):
        ckpt["optimizer"] = cpu(model.optimizer.state_dict())
        if model.discriminator is not None:
            ckpt["disc_state_dict"] = cpu(model.discriminator.state_dict())
            ckpt["sn_state"] = cpu(model.sn_state)
            ckpt["disc_optimizer"] = cpu(model.disc_optimizer.state_dict())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(ckpt, path)


def _load(path: str) -> dict:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
        raise ValueError(f"{path!r} is not a checkpoint ({{'epoch','state_dict'}})")
    return ckpt


def _set_discriminator(trainer: "Trainer", ckpt: dict, path: str) -> None:
    if trainer.discriminator is None:
        raise ValueError(f"{path!r} holds a discriminator but none is configured "
                         "(weight_disc_loss == 0)")
    trainer.discriminator.load_state_dict(ckpt["disc_state_dict"], strict=True)
    trainer.sn_state = {k: {kk: vv.to(trainer.device) for kk, vv in v.items()}
                        for k, v in ckpt["sn_state"].items()}
    if "disc_optimizer" in ckpt:
        trainer.disc_optimizer.load_state_dict(ckpt["disc_optimizer"])


def load_discriminator(path: str, trainer: "Trainer") -> None:
    """The discriminator, its spectral state and its Adam from the checkpoint
    at ``path`` into ``trainer`` (``--retrain_disc``); the generator slot of
    that file is not read. A discriminator checkpoint of the original reference
    loads as :func:`load_any_checkpoint` loads it. Raises ``ValueError`` if the
    file holds no discriminator (the JAX package's ``run_training`` does the
    same)."""
    ckpt = _load(path)
    if convert.is_reference_discriminator(ckpt["state_dict"]):
        _load_reference(path, ckpt, trainer)
    elif "disc_state_dict" in ckpt:
        _set_discriminator(trainer, ckpt, path)
    else:
        raise ValueError(f"--retrain_disc {path!r}: checkpoint has no discriminator state")


def load_checkpoint(path: str, model):
    """Load a checkpoint written by :func:`save_checkpoint` (or by
    ``tools/export_torch_checkpoint.py``) into ``model``, a ``Trainer`` or a
    bare generator. Returns ``(model, epoch)``.

    Into a ``Trainer``: the generator, and whatever else of the training state
    the file holds, on the trainer's device: the generator's Adam (moments and
    step counts; ``Optimizer.load_state_dict`` puts them beside the
    parameters) and the discriminator with its spectral state and Adam. What
    the file lacks keeps its fresh state: an export of a JAX checkpoint carries
    no Adam moments (as the JAX package's ``.pth`` path), and one written
    without a discriminator leaves the trainer's as initialised. A checkpoint
    of the original PyTorch reference (its module names) raises ``ValueError``:
    :func:`load_any_checkpoint` converts those."""
    ckpt = _load(path)
    if convert.is_reference_state_dict(ckpt["state_dict"]):
        raise ValueError(
            f"{path!r} is a checkpoint of the original PyTorch reference (its module "
            "names); load it with load_any_checkpoint")
    return _restore(path, ckpt, model)


def _restore(path: str, ckpt: dict, model):
    epoch = int(ckpt.get("epoch", 0))
    if isinstance(model, torch.nn.Module):
        model.load_state_dict(ckpt["state_dict"], strict=True)
        return model, epoch
    model.generator.load_state_dict(ckpt["state_dict"], strict=True)
    if "optimizer" in ckpt:
        model.optimizer.load_state_dict(ckpt["optimizer"])
    if "disc_state_dict" in ckpt and model.discriminator is not None:
        _set_discriminator(model, ckpt, path)
    return model, epoch


def _load_reference(path: str, ckpt: dict, model):
    """A checkpoint of the original PyTorch reference (``{'epoch', 'state_dict',
    'optimizer'}``, reference train.py:781-786) into ``model``, as the JAX
    package's ``load_any_checkpoint`` loads a ``.pth``: a generator's weights
    into the generator, a discriminator's (``discriminator_net.*``) into the
    trainer's discriminator and its spectral state; the reference's Adam
    moments are not carried over, so the optimizer of what was loaded starts
    afresh."""
    sd = ckpt["state_dict"]
    trainer = None if isinstance(model, torch.nn.Module) else model
    if convert.is_reference_discriminator(sd):
        if trainer is None or trainer.discriminator is None:
            raise ValueError(f"{path!r} is a discriminator checkpoint but no discriminator "
                             "is configured (weight_disc_loss == 0)")
        disc_sd, sn = convert.reference_to_torch_discriminator(sd)
        trainer.discriminator.load_state_dict(disc_sd, strict=True)
        # a conv whose power-iteration vectors the file lacks keeps its own
        trainer.sn_state.update({k: {kk: vv.to(trainer.device) for kk, vv in v.items()}
                                 for k, v in sn.items()})
        trainer.disc_optimizer.state.clear()
        return
    gen = model if trainer is None else trainer.generator
    gen.load_state_dict(convert.reference_to_torch_generator(sd), strict=True)
    if trainer is not None:
        trainer.optimizer.state.clear()


def load_any_checkpoint(path: str, model):
    """A checkpoint of this package (:func:`load_checkpoint`), or one of the
    original PyTorch reference: a ``.pth`` or any file whose ``state_dict`` has
    the reference's module names, converted on the fly
    (``models/convert.py``). Such a file restores the weights and the epoch it
    stores; a discriminator file goes to the trainer's discriminator (a
    ``ValueError`` without one) and leaves the generator as it is. Returns
    ``(model, epoch)`` as :func:`load_checkpoint`."""
    ckpt = _load(path)
    if path.endswith(".pth") or convert.is_reference_state_dict(ckpt["state_dict"]):
        _load_reference(path, ckpt, model)
        return model, int(ckpt.get("epoch", 0))
    return _restore(path, ckpt, model)

"""The train/val step (PyTorch counterpart of ``spsg_tpu/training/step.py``,
itself a rebuild of the reference hot loop, torch/train.py:419-757).

Ported so far: the part of the step that needs no raycaster, i.e. what the
JAX package's ``Trainer._step`` does for any ``StepFlags`` with
``use_2d=False``: generator forward, occupancy BCE, (log-)L1 SDF and 3D
semantic cross-entropy, backward through all eligible convs (hand-written CUDA
kernels on a CUDA device, ``ops/conv3x3.py``) and the generator's Adam step.
That is the whole geometry-only phase of the curriculum, every run without
frames, and the 3D semantic term. The 2D half (normals, raycasts, depth chain,
2D losses, discriminator, style/content) raises ``NotImplementedError`` until
it is ported (ROADMAP.md).

PyTorch idiom: the state lives in the generator module and its optimizer, not
in a state object threaded through the step. The JAX package's scheduling
options for its compiler (``step_many``, ``precompute_views``,
``compact_resid``, ``remat``) have no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data import category
from ..losses import geo as geo_losses
from ..losses import semantic as sem_losses
from .config import StepFlags, TrainConfig
from .state import gen_optimizer, init_generator, resolve_device

_UNPORTED_FLAGS = ("use_2d", "use_disc", "compute_style", "compute_content")


class Trainer:
    """Owns the generator, its optimizer, the class weights and the iteration
    count. ``seed`` draws the initial weights (``training/state.py::
    init_generator``); ``plain_convs`` is the generator's testing hook (the
    kernels' plain versions on any device)."""

    def __init__(self, cfg: TrainConfig, device="cuda", seed: int = 0,
                 plain_convs: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = init_generator(cfg, torch.Generator().manual_seed(seed), self.device,
                                        plain_convs=plain_convs)
        self.optimizer = gen_optimizer(cfg, self.generator.parameters())
        self.class_weights = torch.as_tensor(
            np.asarray(category.CLASS_WEIGHTS, np.float32), device=self.device)
        self.iteration = 0

    # -- public API ---------------------------------------------------------

    def step(self, batch, flags: StepFlags,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One train step (``flags.train``) or validation pass (eval-mode
        BatchNorm, no update, no change of the running statistics).

        ``batch`` is a dict of numpy arrays or tensors in the layout of
        ``data/pipeline.py`` plus the scalar ``weight_occ``. ``generator`` is
        the source of the step's randomness; the ported part of the step draws
        none. Returns the metrics under the JAX package's names as 0-dim
        tensors on the device: nothing in here waits for the device."""
        for name in _UNPORTED_FLAGS:
            if getattr(flags, name):
                raise NotImplementedError(
                    f"StepFlags.{name}: the 2D half of the train step (raycasts, 2D losses, "
                    "discriminator, style/content) is not ported yet (ROADMAP.md)"
                )
        batch = self._to_device(batch)
        self.generator.train(flags.train)
        with torch.set_grad_enabled(flags.train):
            loss, metrics = self._forward_losses(batch, flags)
        if flags.train:
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            # every parameter takes every step, as in the JAX package: one the
            # loss did not reach (the colour head without 2D losses) has a
            # zero gradient, is still decayed and still counts the step
            for p in self.generator.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.optimizer.step()
            self.iteration += 1
        metrics["loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    # -- internals ----------------------------------------------------------

    def _to_device(self, batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, (np.ndarray, np.generic, float, int)):
                v = torch.as_tensor(v)
            if isinstance(v, torch.Tensor):
                if v.dtype == torch.float64:
                    v = v.float()
                out[k] = v.to(self.device, non_blocking=True)
        return out

    def _forward_losses(self, batch, flags: StepFlags):
        """The 3D losses (``_forward_losses`` of the JAX package up to its 2D
        block). Returns (loss, metrics)."""
        cfg = self.cfg
        trunc = cfg.truncation
        metrics: Dict[str, torch.Tensor] = {}

        occ_logits, pred_sdf, _pred_color, pred_sem = self.generator(
            batch["input"], batch["mask"], pred_color=flags.pred_color, pred_sdf=True,
            pred_semantic=flags.pred_semantic)
        occ_logits = occ_logits[..., 0]
        pred_sdf_g = pred_sdf[..., 0]

        target_sdf = geo_losses.compute_targets(batch["target_sdf"], trunc)
        known = None
        if cfg.use_loss_masking and "known" in batch:
            known = batch["known"] <= 1  # reference train.py:445-446
        input_sdf = batch["input"][..., 0]
        input_occ = input_sdf.abs() < trunc - 0.01
        weight = geo_losses.dense_geo_weights(
            target_sdf, input_occ, trunc, cfg.weight_surf_geo, cfg.weight_missing_geo)
        # zero loss where the model predicts empty (train.py:479-481)
        empty = torch.sigmoid(occ_logits.detach()) < 0.5
        weight = torch.where(empty, 0.0, weight)

        loss_occ = geo_losses.occ_loss(target_sdf, occ_logits, known, weight, trunc)
        # weight_occ is 1 during the geo-only phase, weight_occ_loss after
        # (train.py:476)
        loss = batch["weight_occ"] * loss_occ
        metrics["loss_occ"] = loss_occ
        metrics["iou_occ"] = geo_losses.occ_iou(target_sdf, occ_logits.detach(), known, trunc)

        if flags.pred_sdf and cfg.weight_sdf_loss > 0:
            loss_sdf = geo_losses.sdf_l1_loss(
                target_sdf, pred_sdf_g, known, weight, cfg.logweight_sdf)
            loss = loss + cfg.weight_sdf_loss * loss_sdf
            metrics["loss_sdf"] = loss_sdf

        # sparsification mask of the prediction (train.py:493-498)
        surface_pred = (pred_sdf_g.detach().abs() < trunc) & ~empty

        if flags.pred_semantic and cfg.pred_3d_semantic:
            loss_sem = sem_losses.semantic_3d_loss(
                pred_sem, batch["semantics"], surface_pred, self.class_weights)
            loss = loss + cfg.weight_semantic_loss * loss_sem
            metrics["loss_semantic"] = loss_sem
        return loss, metrics

"""Plain full training step of the reference (reference torch/train.py:419-757,
as the port's ``training/step.py::Trainer.step`` computes it), in plain
PyTorch: the plain generator (``generator.py``), the 3D losses, the 2D block
with three plain raycasts and the plain depth chain, the spectral-norm patch
discriminator and its update, one backward of ``loss_rest + weight_discgen *
gate * gen_loss`` to the generator, and Adam on both networks.

It supports the configuration the benchmark trains: one frame a chunk, the
vanilla / hinge / wgan losses, projected targets; no style or content, no
missing-colour weights, no whole-batch skip (``Reference`` raises on others).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from . import category
from . import depth as depth_ops
from . import losses_gan as gan_losses
from . import losses_geo as geo_losses
from . import losses_semantic as sem_losses
from . import losses_twod as twod_losses
from .discriminator import Discriminator2D
from .generator import Generator
from .normals3d import surface_normals
from .raycast import RaycastConfig, raycast

NEG_INF = -float("inf")


def _sanitize(img, fill=0.0):
    return torch.where(torch.isfinite(img), img, fill)


def _scale_color(x):
    return torch.cat([x[..., :3] * 2.0 - 1.0, x[..., 3:]], dim=-1)


class Reference:
    """The generator, the discriminator with its spectral state and both Adams,
    built from the configuration's dict (``configs/<name>.json``'s ``train``)
    and loaded from the state dicts the benchmark hands both sides."""

    def __init__(self, cfg: Dict, gen_state, disc_state, sn_state, device):
        unsupported = dict(weight_style_loss=0.0, weight_content_loss=0.0,
                           weight_missing_color=1.0, skip_batch_on_bad_depth=False,
                           weight_by_percent_pixels=False, project_targets=True)
        for k, v in unsupported.items():
            if cfg[k] != v:
                raise ValueError(f"reference step: {k}={cfg[k]!r} is not supported")
        self.cfg = cfg
        self.device = device
        self.generator = Generator(cfg["nf_gen"], cfg["truncation"]).to(device)
        self.generator.load_state_dict(gen_state)
        per = 3 * (cfg["weight_depth_loss"] > 0) + 3 * (cfg["weight_color_loss"] > 0)
        self.discriminator = Discriminator2D(
            nf_in=2 * per, nf=cfg["nf_disc"], patch_size=cfg["patch_size"],
            image_dims=(cfg["style_height"], cfg["style_width"]), patch=cfg["patch_disc"],
            disc_loss_type=cfg["disc_loss_type"]).to(device)
        self.discriminator.load_state_dict(disc_state)
        self.sn_state = {k: {n: t.to(device).clone() for n, t in v.items()}
                         for k, v in sn_state.items()}
        self.optimizer = torch.optim.Adam(self.generator.parameters(), lr=cfg["lr"],
                                          betas=(0.9, 0.999), eps=1e-8,
                                          weight_decay=cfg["weight_decay"])
        self.disc_optimizer = torch.optim.Adam(self.discriminator.parameters(),
                                               lr=cfg["d_lr_factor"] * cfg["lr"],
                                               betas=(0.9, 0.999), eps=1e-8,
                                               weight_decay=cfg["weight_decay"])
        self.class_weights = torch.as_tensor(np.asarray(category.CLASS_WEIGHTS, np.float32),
                                             device=device)
        self.rc = RaycastConfig(
            width=cfg["style_width"], height=cfg["style_height"],
            depth_min=cfg["raycast_depth_min"] / cfg["voxelsize"],
            depth_max=cfg["raycast_depth_max"] / cfg["voxelsize"],
            ray_increment=0.3 * cfg["truncation"],
            thresh_sample_dist=50.5 * 0.3 * cfg["truncation"], march_block=cfg["march_block"])

    def step(self, batch) -> Dict[str, float]:
        """One full train step on ``batch`` (tensors on the device, the
        port's layout, ``weight_occ`` a scalar). Returns the metrics as floats."""
        cfg = self.cfg
        self.generator.train()
        loss_rest, metrics, aux = self._forward_losses(batch)
        gen_l = self._discriminator_step(aux, metrics)
        total = loss_rest + cfg["weight_discgen_loss"] * aux["gate2d"] * gen_l
        params = list(self.generator.parameters())
        self.optimizer.zero_grad(set_to_none=True)
        total.backward(inputs=params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        metrics["loss"] = total
        return {k: float(v.detach()) for k, v in metrics.items()}

    def _forward_losses(self, batch):
        cfg = self.cfg
        trunc = cfg["truncation"]
        metrics = {}
        occ_logits, pred_sdf, pred_color, pred_sem = self.generator(
            batch["input"], batch["mask"], pred_color=True, pred_semantic=True)
        occ_logits = occ_logits[..., 0]
        pred_sdf = pred_sdf[..., 0]
        target_sdf = geo_losses.compute_targets(batch["target_sdf"], trunc)
        known = batch["known"] <= 1 if cfg["use_loss_masking"] else None
        input_sdf = batch["input"][..., 0]
        weight = geo_losses.dense_geo_weights(target_sdf, input_sdf.abs() < trunc - 0.01, trunc,
                                              cfg["weight_surf_geo"], cfg["weight_missing_geo"])
        empty = torch.sigmoid(occ_logits.detach()) < 0.5
        weight = torch.where(empty, 0.0, weight)
        loss_occ = geo_losses.occ_loss(target_sdf, occ_logits, known, weight, trunc)
        loss = batch["weight_occ"] * loss_occ
        metrics["loss_occ"] = loss_occ
        metrics["iou_occ"] = geo_losses.occ_iou(target_sdf, occ_logits.detach(), known, trunc)
        loss_sdf = geo_losses.sdf_l1_loss(target_sdf, pred_sdf, known, weight,
                                          cfg["logweight_sdf"])
        loss = loss + cfg["weight_sdf_loss"] * loss_sdf
        metrics["loss_sdf"] = loss_sdf
        surface_pred = (pred_sdf.detach().abs() < trunc) & ~empty
        if cfg["pred_3d_semantic"]:
            loss_sem = sem_losses.semantic_3d_loss(pred_sem, batch["semantics"], surface_pred,
                                                   self.class_weights)
            loss = loss + cfg["weight_semantic_loss"] * loss_sem
            metrics["loss_semantic"] = loss_sem
        loss2d, metrics2d, aux = self._2d_losses(batch, target_sdf, pred_sdf, pred_color,
                                                 pred_sem, surface_pred)
        metrics.update(metrics2d)
        return loss + loss2d, metrics, aux

    def _2d_losses(self, batch, target_sdf, pred_sdf, pred_color, pred_sem, surface_pred):
        cfg = self.cfg
        trunc = cfg["truncation"]
        rc = self.rc
        metrics = {}
        images_depth = batch["images_depth"]
        images_color = batch["images_color"].permute(0, 2, 3, 1)
        view, intr = batch["images_view"], batch["images_intrinsic"]
        images_normals, _, frames_ok = depth_ops.depth_to_normals_plain(
            images_depth, intr, cfg["max_depth_fill_iters"])
        gate2d = frames_ok.all().float()
        view_inv_rot = torch.linalg.inv(view)[:, :3, :3]
        input_grid = batch["input"]
        with torch.no_grad():
            input_sdf = input_grid[..., 0]
            input_valid = input_sdf.abs() < trunc
            input_normals = surface_normals(input_sdf, torch.ones_like(input_valid),
                                            view_inv_rot)
            tgt_valid = target_sdf.abs() < trunc
            tgt_normals = surface_normals(target_sdf, tgt_valid, view_inv_rot)
            sem_onehot = F.one_hot(batch["semantics"].long(), 15)[..., :14].float()
            rc_in = raycast(input_sdf, input_valid, input_grid[..., 1:4], input_normals, None,
                            view, intr, rc)
            rc_tgt = raycast(target_sdf, tgt_valid, batch["target_colors"] / 255.0, tgt_normals,
                             sem_onehot, view, intr, rc)
        pred_normals = surface_normals(pred_sdf, surface_pred, view_inv_rot)
        rc_pred = raycast(pred_sdf, surface_pred, (pred_color + 1.0) * 0.5, pred_normals,
                          pred_sem, view, intr, rc)
        normals_in = _sanitize(rc_in.normal)
        input2d = torch.cat([_sanitize(rc_in.color * 2.0 - 1.0), normals_in], dim=-1)
        invalid_c = rc_tgt.color == NEG_INF
        if cfg["filter_proj_tgt"]:
            invalid_c = twod_losses.filter_proj_target(
                rc_tgt.color, cfg["color_thresh"], cfg["color_space"])[..., None] | invalid_c
        t_color = torch.where(invalid_c, images_color, rc_tgt.color) * 2.0 - 1.0
        t_norm = torch.where(rc_tgt.normal == NEG_INF, images_normals, rc_tgt.normal)
        target2d = torch.cat([t_color, t_norm], dim=-1)
        target2d_label = sem_losses.rendered_semantic_label(rc_tgt.semantic)

        loss_depth = twod_losses.depth_l1_loss(rc_pred.depth, images_depth, cfg["voxelsize"])
        loss2d = cfg["weight_depth_loss"] * gate2d * loss_depth
        metrics["loss_depth"] = loss_depth
        if cfg["weight_color_loss"] > 0:
            loss_color = twod_losses.color_l1_loss(rc_pred.color, images_color, None)
            loss2d = loss2d + cfg["weight_color_loss"] * gate2d * loss_color
            metrics["loss_color"] = loss_color
        stack = torch.cat([rc_pred.color, rc_pred.normal], dim=-1)
        valid_px = stack.detach() != NEG_INF
        gate_numvalid = (valid_px.sum() > cfg["min_num_valid_2d"]).float()
        valid_patches = None
        if cfg["patch_disc"] and cfg["patch_size"] < cfg["style_height"]:
            vp = self.discriminator.compute_valids(valid_px[..., -1:].float())
            valid_patches = vp[..., 0] > cfg["valid_thresh"]
            gate_numvalid = gate_numvalid * (valid_patches.sum() > 0).float()
        if not cfg["pred_3d_semantic"]:
            loss_sem2d = sem_losses.semantic_2d_loss(rc_pred.semantic, target2d_label,
                                                     self.class_weights)
            loss2d = loss2d + cfg["weight_semantic_loss"] * gate2d * loss_sem2d
            metrics["loss_semantic"] = loss_sem2d
        tgt_stack = torch.cat([images_color, images_normals], dim=-1)
        synth_r, _ = twod_losses.preprocess_rendered_target_images(stack, tgt_stack)
        synth = torch.cat([input2d, _scale_color(synth_r)], dim=-1)
        target_img = torch.cat([input2d, target2d], dim=-1).detach()
        aux = dict(synth=synth, target_img=target_img, valid_patches=valid_patches,
                   gate2d=gate2d * gate_numvalid)
        return loss2d, metrics, aux

    def _discriminator_step(self, aux, metrics):
        cfg = self.cfg
        disc = self.discriminator
        synth, target_img = aux["synth"], aux["target_img"]
        vp = aux["valid_patches"] if cfg["patch_disc"] else None
        d_real, sn1 = disc(target_img, self.sn_state, True)
        d_fake, sn2 = disc(synth.detach(), sn1, True)
        real_l, fake_l = gan_losses.discriminator_loss(cfg["disc_loss_type"], d_real, d_fake,
                                                       vp, None)
        if cfg["disc_loss_type"].startswith("wgan"):
            if cfg["disc_loss_type"] == "wgan_gp":
                raise ValueError("reference step: wgan_gp is not supported")
            dl = cfg["weight_disc_loss"] * 0.005 * (real_l + fake_l)
        else:
            dl = cfg["weight_disc_loss"] * (real_l + fake_l)
        metrics["loss_disc"] = dl.detach()
        metrics["loss_disc_real"] = real_l.detach()
        metrics["loss_disc_fake"] = fake_l.detach()
        dparams = list(disc.parameters())
        self.disc_optimizer.zero_grad(set_to_none=True)
        dl.backward(inputs=dparams)
        for p in dparams:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if bool(aux["gate2d"] > 0):
            self.disc_optimizer.step()
        self.sn_state = sn2
        d_fake_g, _ = disc(synth, self.sn_state, False)
        gen_l = gan_losses.generator_loss(cfg["disc_loss_type"], d_fake_g)
        metrics["loss_gen"] = gen_l.detach()
        return gen_l

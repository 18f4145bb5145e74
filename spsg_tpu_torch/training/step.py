"""The train/val step (PyTorch counterpart of ``spsg_tpu/training/step.py``,
itself a rebuild of the reference hot loop, torch/train.py:419-757).

One call runs, as the JAX package's ``Trainer._step`` does: generator
forward, 3D occupancy / SDF / semantic losses and, with ``StepFlags.use_2d``,
the 2D view-guided block: SDF-gradient normals, three raycasts (input,
projected target, prediction; the first two without gradient, so one
backward scatter a step), the depth chain on the target frame, depth and
colour L1, the VGG style / content losses (``compute_style`` /
``compute_content``, with a ``vgg`` extractor) and the 2D semantic CE. With
``use_disc`` the discriminator is updated on the detached render first, then
the generator's adversarial loss is taken against the *updated*
discriminator, and one backward of
``loss_rest + weight_discgen * gate * gen_loss`` reaches the generator
(train.py:726-732). Hand-written CUDA kernels on a card: the generator's
convs (``ops/conv3x3.py``) and the raycaster's march, shade and scatter
(``ops/raycast.py``).

The gates are the JAX package's: ``gate2d`` (every frame's depth holes
filled) multiplies the 2D losses; ``gate2d * gate_numvalid`` (enough valid
rendered pixels and patches) multiplies the adversarial term and predicates
the discriminator's optimizer step, while its spectral statistics move in
either case. Deciding that predicate reads one flag back to the host per
step; the depth chain's early exit reads at most ``max_depth_fill_iters + 1``
more (``ops/depth.py``). ``skip_batch_on_bad_depth`` reads one more.

``weight_missing_color > 1`` weights the colour L1 and the discriminator's
patches where the target surface lies in a region the input misses: two
occupancy raycasts (``raycast_occ``, kernel K7 on a card) a step.
:meth:`Trainer.precompute_views` computes what depends on the batch alone (the
input and target march hits, the depth chain, the occupancy masks); a step fed
those (``precomp``, as the training loop's ``RenderCache`` does) shades the
cached hits and marches only the prediction, with the same results to the bit.
The depth chain decides per frame whether to filter and fill
(``ops/depth.py::fill_depth_holes``), so that a frame's views do not depend
on its batch-mates; the JAX package decides for the whole batch (the two
differ only on a batch that mixes frames with and without holes, ROADMAP.md
Queue C).

The style / content block converts the render and the target frame from LAB
to RGB when ``color_space == "lab"``, sanitising the render's ``-inf`` pixels
*before* the conversion, as the JAX package does: a NaN made there would be
hidden from the forward by the select that restores ``-inf`` but not from the
backward, which would carry it into the raycaster's scatter. The target's
features carry no gradient and are computed under ``torch.no_grad()``; the
VGG's parameters are frozen, outside both optimizers and the checkpoint.

``TrainConfig.compute_dtype="bfloat16"`` trains the generator in bfloat16, as
the JAX package's generator ``dtype``: its blocks compute in bfloat16 (the
bf16 variants of the conv kernels, forward, dx and dW), its parameters, their
Adam state, the four heads and the losses stay float32; the discriminator is
float32 either way. ``TrainConfig.remat`` recomputes the generator's conv blocks
in the backward (``models/generator.py``). The JAX package's compiler
scheduling (``step_many``, ``compact_resid``, ``fuse_raycast``,
``pair_raycast``) has no counterpart: the three raycasts run one after the
other, which is the JAX package's default.

With the recorder of ``utils/timing.py`` on, a step is one span tree:
``train.step`` → ``train.forward`` (→ ``train.generator``, ``train.losses3d``,
``train.twod`` → ``train.host_read`` around ``torch.linalg.inv``, which
synchronises on a card), ``train.disc`` (→ ``train.host_read`` around the
gate's read, ``train.disc_optim``), ``train.backward`` (with the depth gate's
``train.host_read``), ``train.optim``; the counters are ``train.steps`` and
``train.host_reads``, one a span ``train.host_read``: on a card these are the
step's only waits for the device (torch's sync debug mode finds no other).
The plain depth fill's reads, on CPU tensors, count in ``ops/depth.py``'s
``host_syncs``.

PyTorch idiom: the state lives in the modules, their optimizers and the
discriminator's spectral state, not in a state object threaded through the
step.

Data-parallel training (``Trainer(..., mesh=parallel.make_mesh())``, one
process a device, ``parallel/multihost.py``): each rank steps on its rows of
the global batch and every reduction is the global batch's, as GSPMD makes
them in the JAX package: BatchNorm's batch statistics (the fused kernel's sums
all-reduced, ``models/generator.py``), every loss's masked mean, the IoU, the
gates (``gate2d``, the valid-pixel count, the valid patches, the depth gate of
``skip_batch_on_bad_depth``, and so the discriminator's update: every rank
takes the same branch), the patch weights' maximum and the style loss's Gram
matrices. Each rank's loss is the global loss; the parameter gradients of
both networks are summed over the ranks before each Adam step
(``parallel/mesh.py``), so the rank's step equals the one-process step on the
global batch. The gradient penalty's ``alpha`` is drawn for the global batch
and each rank takes its rows. The parameters, the Adam state and the
spectral state start as rank 0's (``replicate_state``) and stay identical,
since every rank applies the same update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data import category, colorspace
from ..losses import gan as gan_losses
from ..losses import geo as geo_losses
from ..losses import semantic as sem_losses
from ..losses import style as style_losses
from ..losses import twod as twod_losses
from ..ops import depth as depth_ops
from ..ops import normals3d
from ..ops import raycast as raycast_ops
from ..ops.raycast import RaycastConfig, raycast
from ..parallel import mesh as pmesh
from ..utils import timing
from .config import StepFlags, TrainConfig
from .state import (
    disc_optimizer, gen_optimizer, init_discriminator, init_generator, resolve_device)

NEG_INF = -float("inf")


def _raycast_cfg(cfg: TrainConfig) -> RaycastConfig:
    return RaycastConfig(
        width=cfg.style_width,
        height=cfg.style_height,
        depth_min=cfg.raycast_depth_min / cfg.voxelsize,
        depth_max=cfg.raycast_depth_max / cfg.voxelsize,
        ray_increment=cfg.ray_increment,
        thresh_sample_dist=cfg.thresh_sample_dist,
        march_block=cfg.march_block,
    )


def _frames(batch):
    """The batch's frames flattened to a B*F frame batch (reference RaycastRGBD
    max_num_frames, style.py:9-16): (images_depth (B*F,H,W), images_color
    (B*F,3,H,W) or None, view (B*F,4,4) camera->grid, intrinsics (B*F,4), and a
    function that repeats a (B, ...) volume F times)."""
    images_depth = batch["images_depth"]
    images_color = batch.get("images_color")
    view, intr = batch["images_view"], batch["images_intrinsic"]
    n_frames = 1
    if images_depth.dim() == 4:  # (B, F, H, W)
        n_frames = images_depth.shape[1]
        images_depth = images_depth.reshape((-1,) + tuple(images_depth.shape[2:]))
        if images_color is not None:
            images_color = images_color.reshape((-1,) + tuple(images_color.shape[2:]))
        view, intr = view.reshape(-1, 4, 4), intr.reshape(-1, 4)

    def rep(g):
        return g.repeat_interleave(n_frames, dim=0) if n_frames > 1 else g

    return images_depth, images_color, view, intr, rep


def _sanitize(img, fill=0.0):
    return torch.where(torch.isfinite(img), img, fill)


def _host_read(fn, *args):
    """``fn(*args)``, a call that waits for the device: a flag read back to
    the host (``fn`` ``bool``), or a library call that synchronises. The step
    waits here for the device to reach it (the span ``train.host_read``,
    counted in ``train.host_reads``)."""
    with timing.span("train.host_read"):
        timing.count("train.host_reads")
        return fn(*args)


def _scale_color(x):
    """The first three channels mapped from [0, 1] to [-1, 1]."""
    return torch.cat([x[..., :3] * 2.0 - 1.0, x[..., 3:]], dim=-1)


class Trainer:
    """Owns the generator, the discriminator (when ``weight_disc_loss > 0``)
    with its spectral state, their optimizers, the class weights and the
    iteration count. ``seed`` draws the initial weights (generator first, then
    the discriminator, from one CPU ``torch.Generator``); ``plain_convs`` is
    the generator's testing hook (the kernels' plain versions on any
    device). ``vgg`` (``models/vgg.py::VGGFeatures``) is the style / content
    extractor, moved to the trainer's device and frozen; the steps that
    compute style or content need it. ``mesh`` (``parallel.Mesh``) trains
    data-parallel over its ranks (the module docstring); every rank
    constructs its trainer with the same arguments."""

    def __init__(self, cfg: TrainConfig, device="cuda", seed: int = 0,
                 plain_convs: bool = False, vgg=None, mesh=None):
        self.cfg = cfg
        self.mesh = pmesh.check_mesh(mesh)
        self.device = resolve_device(device)
        rng = torch.Generator().manual_seed(seed)
        self.generator = init_generator(cfg, rng, self.device, plain_convs=plain_convs)
        self.optimizer = gen_optimizer(cfg, self.generator.parameters())
        self.discriminator = self.disc_optimizer = None
        self.sn_state = {}
        if cfg.weight_disc_loss > 0:
            self.discriminator, self.sn_state = init_discriminator(cfg, rng, self.device)
            self.disc_optimizer = disc_optimizer(cfg, self.discriminator.parameters())
        self.vgg = None if vgg is None else vgg.to(self.device).eval().requires_grad_(False)
        # the step's own randomness (the gradient penalty's alpha)
        self.rng = torch.Generator().manual_seed(seed + 1)
        self.class_weights = torch.as_tensor(
            np.asarray(category.CLASS_WEIGHTS, np.float32), device=self.device)
        self.iteration = 0
        pmesh.replicate_state(self, self.mesh)

    # -- public API ---------------------------------------------------------

    def step(self, batch, flags: StepFlags, generator: Optional[torch.Generator] = None,
             gp_alpha=None, precomp=None) -> Dict[str, torch.Tensor]:
        """One train step (``flags.train``) or validation pass (eval-mode
        BatchNorm, no update, no change of any state).

        ``batch`` is a dict of numpy arrays or tensors in the layout of
        ``data/pipeline.py`` plus the scalar ``weight_occ``; with ``use_2d``
        also ``images_depth`` (B[,F],H,W), ``images_color`` (B[,F],3,H,W),
        ``images_view`` (B[,F],4,4) and ``images_intrinsic`` (B[,F],4).
        ``generator`` (CPU ``torch.Generator``, default the trainer's own) draws
        the gradient penalty's ``alpha`` (``wgan_gp``) for the global batch,
        unless ``gp_alpha`` (the global batch's, B*F*ranks,1,1,1) is given;
        the rank takes its rows. Under a mesh ``batch`` is the rank's rows. ``precomp`` is what :meth:`precompute_views` gives
        for this batch, or a tuple of per-sample slices of it (the training
        loop's cache entries), concatenated here; the 2D block then uses it in
        place of the input and target marches and the depth chain. Returns the
        metrics under the JAX package's names as 0-dim tensors on the device."""
        with timing.span("train.step"):
            timing.count("train.steps")
            return self._step(batch, flags, generator, gp_alpha, precomp)

    def _step(self, batch, flags, generator, gp_alpha, precomp):
        cfg = self.cfg
        self._check_flags(flags)
        batch = self._to_device(batch)
        if isinstance(precomp, (list, tuple)):
            precomp = {k: torch.cat([p[k] for p in precomp], dim=0) for k in precomp[0]}
        if precomp is not None:
            precomp = self._to_device(precomp)
        train = flags.train
        self.generator.train(train)
        skip_on_depth = train and flags.use_2d and cfg.skip_batch_on_bad_depth
        saved_buffers = ({k: v.clone() for k, v in self.generator.named_buffers()}
                         if skip_on_depth else None)
        with timing.span("train.forward"), torch.set_grad_enabled(train):
            loss_rest, metrics, aux = self._forward_losses(batch, flags, precomp)
        gate = aux["gate2d"]
        total_loss = loss_rest
        if flags.use_disc and self.discriminator is not None:
            with timing.span("train.disc", stream=True):
                gen_l = self._discriminator_step(flags, aux, metrics, generator, gp_alpha)
            total_loss = loss_rest + cfg.weight_discgen_loss * gate * gen_l
        if train:
            with timing.span("train.backward"):
                params = list(self.generator.parameters())
                self.optimizer.zero_grad(set_to_none=True)
                # the generator's parameters only: the adversarial term also
                # reaches the discriminator's, which have taken their step already
                total_loss.backward(inputs=params)
                # every parameter takes every step, as in the JAX package: one
                # the loss did not reach has a zero gradient, is still decayed
                # and still counts the step
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                pmesh.sum_gradients(params, self.mesh)
                depth_ok = not skip_on_depth or _host_read(bool, aux["gate_depth"] > 0)
            if not depth_ok:
                # the reference's whole-batch skip (train.py:539-541): no
                # optimizer step, no running statistics, no iteration
                with torch.no_grad():
                    for k, v in self.generator.named_buffers():
                        v.copy_(saved_buffers[k])
            else:
                with timing.span("train.optim", stream=True):
                    self.optimizer.step()
                self.iteration += 1
        metrics["loss"] = total_loss
        return {k: v.detach() for k, v in metrics.items()}

    def precompute_views(self, batch) -> Dict[str, torch.Tensor]:
        """What the 2D block computes from the batch alone, once per (chunk,
        frames) (``spsg_tpu/training/step.py::precompute_views``): the input
        and projected-target marches, the depth chain and, with
        ``weight_missing_color > 1``, the occupancy masks. None of it depends on
        the parameters, and no sample's entries on another's (the depth chain
        runs per frame), so ``step(..., precomp=...)`` gives the same losses and
        updates to the bit as computing them in the step.

        Returns, in the flattened (B*F, ...) frame layout, on the device:
        ``in_hit`` / ``in_hit_idx`` / ``in_depth`` (B*F, P), the same
        ``tgt_*`` with ``project_targets``, ``images_normals`` (B*F, H, W, 3),
        ``frames_ok`` (B*F,) and, with ``weight_missing_color > 1``,
        ``missing2d`` / ``tgt_mask2d`` (B*F, H, W) uint8. Reads
        ``input``, ``target_sdf``, ``images_depth``, ``images_view`` and
        ``images_intrinsic``."""
        cfg = self.cfg
        trunc = cfg.truncation
        rc = _raycast_cfg(cfg)
        batch = self._to_device(batch)
        with torch.no_grad():
            images_depth, _, view, intr, rep = _frames(batch)
            target_sdf = rep(geo_losses.compute_targets(batch["target_sdf"], trunc))
            input_sdf = rep(batch["input"][..., 0])
            images_normals, _, frames_ok = depth_ops.depth_to_normals(
                images_depth, intr, cfg.max_depth_fill_iters)
            out = dict(images_normals=images_normals, frames_ok=frames_ok)
            grids = [("in", input_sdf)] + ([("tgt", target_sdf)] if cfg.project_targets else [])
            for name, sdf in grids:
                hits = raycast_ops.find_surface_crossings(sdf, sdf.abs() < trunc, view, intr, rc)
                out.update({f"{name}_hit": hits["hit"], f"{name}_hit_idx": hits["hit_idx"],
                            f"{name}_depth": hits["depth"]})
            if cfg.weight_missing_color > 1:
                out["missing2d"], out["tgt_mask2d"] = self._occupancy_masks(
                    input_sdf, target_sdf, view, intr)
        return out

    # -- internals ----------------------------------------------------------

    def _check_flags(self, flags: StepFlags) -> None:
        for name in ("compute_style", "compute_content"):
            if getattr(flags, name) and self.vgg is None:
                raise ValueError(
                    f"StepFlags.{name}: the style/content losses need a VGG extractor; "
                    "pass Trainer(..., vgg=models.vgg.load_vgg_for_style(device=...))")

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

    def _occupancy_masks(self, input_sdf, target_sdf, view, intr):
        """(missing2d, tgt_mask2d) (B, H, W) uint8: the rays that meet target
        surface in 8^3 blocks without input geometry, and the rays that meet
        the target's |sdf| < 1 shell, both within ``raycast_occ_depth_max``
        (reference train.py:546-554, a shallower range than the colour
        raycast's, train.py:146-148)."""
        cfg = self.cfg
        trunc = cfg.truncation
        rc_occ = dataclasses.replace(_raycast_cfg(cfg),
                                     depth_max=cfg.raycast_occ_depth_max / cfg.voxelsize)
        missing3d = geo_losses.missing_geo_mask(input_sdf.abs() < trunc - 0.01, target_sdf, trunc)
        return (raycast_ops.raycast_occ(missing3d, view, intr, rc_occ),
                raycast_ops.raycast_occ(target_sdf.abs() < 1, view, intr, rc_occ))

    def _disc(self, x, sn_state, update: bool):
        return self.discriminator(x, sn_state, update_sn_stats=update)

    def _discriminator_step(self, flags, aux, metrics, generator, gp_alpha):
        """The discriminator's losses and, in training, its update on the
        detached render; then the generator's adversarial loss against the
        updated discriminator (returned, differentiable in the render)."""
        cfg = self.cfg
        train = flags.train
        synth = aux["synth"]
        synth_sg = synth.detach()
        target_img = aux["target_img"]
        sn0 = self.sn_state
        weighted = cfg.weight_by_percent_pixels and cfg.disc_loss_type != "hinge"
        mesh = self.mesh
        with torch.set_grad_enabled(train):
            # the stored spectral state threads through the two calls
            d_real, sn1 = self._disc(target_img, sn0, train)
            d_fake, sn2 = self._disc(synth_sg, sn1, train)
            real_l, fake_l = gan_losses.discriminator_loss(
                cfg.disc_loss_type, d_real, d_fake,
                aux["valid_patches"] if cfg.patch_disc else None,
                aux["weight_color_disc"] if cfg.patch_disc else None,
                sample_weight_real=aux["sample_weight_real"] if weighted else None,
                sample_weight_fake=aux["sample_weight_fake"] if weighted else None,
                mesh=mesh,
            )
            if cfg.disc_loss_type.startswith("wgan"):
                dl = cfg.weight_disc_loss * 0.005 * (real_l + fake_l)
                if cfg.disc_loss_type == "wgan_gp" and train:
                    n = target_img.shape[0]
                    ranks = mesh.size if mesh is not None else 1
                    if gp_alpha is None:
                        # drawn for the global batch, the same on every rank
                        gp_alpha = torch.rand((n * ranks, 1, 1, 1),
                                              generator=generator or self.rng)
                    alpha = torch.as_tensor(np.array(gp_alpha, dtype=np.float32)).to(self.device)
                    if ranks > 1:
                        alpha = alpha[mesh.rank * n:(mesh.rank + 1) * n]
                    # from the stored statistics, without an update
                    penalty = gan_losses.gradient_penalty(
                        lambda x: self._disc(x, sn0, False)[0], target_img, synth_sg, alpha,
                        mesh)
                    dl = dl + 10.0 * penalty
            else:
                dl = cfg.weight_disc_loss * (real_l + fake_l)
        metrics["loss_disc"] = dl.detach()
        metrics["loss_disc_real"] = real_l.detach()
        metrics["loss_disc_fake"] = fake_l.detach()
        if train:
            dparams = list(self.discriminator.parameters())
            self.disc_optimizer.zero_grad(set_to_none=True)
            dl.backward(inputs=dparams)
            for p in dparams:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            pmesh.sum_gradients(dparams, mesh)
            # the reference steps the discriminator only with enough valid
            # pixels (train.py:662, 726-727): one host read of the gate a step
            # (a global value: every rank takes the same branch)
            if _host_read(bool, aux["gate2d"] > 0):
                with timing.span("train.disc_optim", stream=True):
                    self.disc_optimizer.step()
            self.sn_state = sn2
        # against the updated parameters and statistics, without an update
        with torch.set_grad_enabled(train):
            d_fake_g, _ = self._disc(synth, self.sn_state, False)
            gen_l = gan_losses.generator_loss(cfg.disc_loss_type, d_fake_g, mesh)
        metrics["loss_gen"] = gen_l.detach()
        return gen_l

    def _forward_losses(self, batch, flags: StepFlags, precomp=None):
        """Everything but the adversarial generator term (``_forward_losses``
        of the JAX package). Returns (loss, metrics, aux)."""
        cfg = self.cfg
        trunc = cfg.truncation
        mesh = self.mesh
        metrics: Dict[str, torch.Tensor] = {}

        with timing.span("train.generator"):
            occ_logits, pred_sdf, pred_color, pred_sem = self.generator(
                batch["input"], batch["mask"], pred_color=flags.pred_color, pred_sdf=True,
                pred_semantic=flags.pred_semantic, mesh=mesh)
            occ_logits = occ_logits[..., 0]
            pred_sdf_g = pred_sdf[..., 0]

        with timing.span("train.losses3d"):
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

            loss_occ = geo_losses.occ_loss(target_sdf, occ_logits, known, weight, trunc, mesh)
            # weight_occ is 1 during the geo-only phase, weight_occ_loss after
            # (train.py:476)
            loss = batch["weight_occ"] * loss_occ
            metrics["loss_occ"] = loss_occ
            metrics["iou_occ"] = geo_losses.occ_iou(target_sdf, occ_logits.detach(), known, trunc,
                                                    mesh)

            if flags.pred_sdf and cfg.weight_sdf_loss > 0:
                loss_sdf = geo_losses.sdf_l1_loss(
                    target_sdf, pred_sdf_g, known, weight, cfg.logweight_sdf, mesh)
                loss = loss + cfg.weight_sdf_loss * loss_sdf
                metrics["loss_sdf"] = loss_sdf

            # sparsification mask of the prediction (train.py:493-498)
            surface_pred = (pred_sdf_g.detach().abs() < trunc) & ~empty

            if flags.pred_semantic and cfg.pred_3d_semantic:
                loss_sem = sem_losses.semantic_3d_loss(
                    pred_sem, batch["semantics"], surface_pred, self.class_weights, mesh)
                loss = loss + cfg.weight_semantic_loss * loss_sem
                metrics["loss_semantic"] = loss_sem

        zero = torch.zeros((), device=self.device)
        aux = dict(synth=None, target_img=None, valid_patches=None, gate2d=zero,
                   gate_depth=zero, sample_weight_real=None, sample_weight_fake=None,
                   weight_color_disc=None)
        if flags.use_2d:
            with timing.span("train.twod", stream=True):
                loss2d, metrics2d, aux2d = self._2d_losses(
                    batch, flags, target_sdf, pred_sdf_g, pred_color, pred_sem, surface_pred,
                    precomp)
            loss = loss + loss2d
            metrics.update(metrics2d)
            aux.update(aux2d)
        return loss, metrics, aux

    def _style_content(self, render_color, images_color, missing2d, flags):
        """(style, content) losses of the prediction's colour render (B*F,H,W,3)
        against the target frames (B*F,H,W,3), both in the network's colour
        space, the render ``-inf`` where it has no hit (JAX ``step.py:712-749``).
        ``missing2d`` (B*F,H,W) or None restricts them to the missing regions."""
        style_pred, style_tgt = render_color, images_color
        if self.cfg.color_space == "lab":
            invalid = style_pred == NEG_INF
            style_pred = torch.where(
                invalid, NEG_INF, colorspace.lab01_to_rgb(_sanitize(style_pred)))
            style_tgt = colorspace.lab01_to_rgb(style_tgt)
        style_pred, style_tgt = twod_losses.preprocess_rendered_target_images(
            style_pred, style_tgt)
        if missing2d is not None:
            # with weight_missing_color > 1 the reference restricts style and
            # content to the missing regions: target pixels are copied into
            # every render pixel outside them (train.py:679-681, style.py:24-29)
            style_pred = torch.where(missing2d[..., None] != 0, style_pred, style_tgt)
        f_out = self.vgg(style_pred)
        with torch.no_grad():
            f_tgt = self.vgg(style_tgt)
        return style_losses.style_content_loss(f_out, f_tgt, flags.compute_style,
                                               flags.compute_content, self.mesh)

    def _2d_losses(self, batch, flags, target_sdf, pred_sdf_g, pred_color, pred_sem,
                   surface_pred, precomp=None):
        """The 2D view-guided block (reference train.py:524-752) without the
        adversarial terms; with ``precomp`` (:meth:`precompute_views`) the
        input and target hits, the depth chain and the occupancy masks come
        from it. Returns (loss2d, metrics, aux)."""
        cfg = self.cfg
        trunc = cfg.truncation
        rc = _raycast_cfg(cfg)
        mesh = self.mesh
        metrics: Dict[str, torch.Tensor] = {}

        images_depth, images_color, view, intr, rep = _frames(batch)
        images_color = images_color.permute(0, 2, 3, 1)  # (B*F,H,W,3)

        target_sdf = rep(target_sdf)
        pred_sdf_g = rep(pred_sdf_g)
        surface_pred = rep(surface_pred)
        if pred_color is not None:
            pred_color = rep(pred_color)
        if pred_sem is not None:
            pred_sem = rep(pred_sem)
        semantics_grid_labels = rep(batch["semantics"]) if "semantics" in batch else None
        input_grid = rep(batch["input"])
        target_colors255 = rep(batch["target_colors"])

        if precomp is not None:
            images_normals, frames_ok = precomp["images_normals"], precomp["frames_ok"]
        else:
            images_normals, _, frames_ok = depth_ops.depth_to_normals(
                images_depth, intr, cfg.max_depth_fill_iters)
        # the reference skips the sample when holes remain (train.py:539-541)
        gate2d = pmesh.all_min(frames_ok.all().float(), mesh)
        # on a card torch.linalg.inv synchronises (it checks its result)
        view_inv_rot = _host_read(torch.linalg.inv, view)[:, :3, :3]

        # per-pixel colour weights where the input misses the target (train.py:546-554)
        weight_color = missing2d = None
        if cfg.weight_missing_color > 1:
            if precomp is not None:
                missing2d, tgt_mask2d = precomp["missing2d"], precomp["tgt_mask2d"]
            else:
                missing2d, tgt_mask2d = self._occupancy_masks(
                    input_grid[..., 0], target_sdf, view, intr)
            weight_color = torch.where((tgt_mask2d != 0) & (missing2d != 0),
                                       cfg.weight_missing_color, 1.0)

        with torch.no_grad():
            # input grids (train.py:556-577)
            input_sdf = input_grid[..., 0]
            input_valid = input_sdf.abs() < trunc
            input_normals = normals3d.surface_normals(
                input_sdf, torch.ones_like(input_valid), view_inv_rot)
            # target grids (train.py:579-616)
            tgt_valid = target_sdf.abs() < trunc
            tgt_normals = normals3d.surface_normals(target_sdf, tgt_valid, view_inv_rot)
            if semantics_grid_labels is not None:
                sem_onehot = F.one_hot(semantics_grid_labels.long(), 15)[..., :14].float()
            else:
                sem_onehot = None
            # three separate raycasts, the input and the projected target
            # without gradient (reference train.py:563,590,626); cached hits
            # are only shaded
            def render(name, sdf, valid, color, normal, semantic):
                if precomp is None:
                    return raycast(sdf, valid, color, normal, semantic, view, intr, rc)
                hits = {k: precomp[f"{name}_{k}"] for k in ("hit", "hit_idx", "depth")}
                return raycast_ops.shade_hits(sdf, color, normal, semantic, hits, rc)

            rc_in = render("in", input_sdf, input_valid, input_grid[..., 1:4], input_normals, None)
            rc_tgt = None
            if cfg.project_targets:
                rc_tgt = render("tgt", target_sdf, tgt_valid, target_colors255 / 255.0,
                                tgt_normals, sem_onehot)

        # prediction grids (train.py:617-632)
        pred_normals = normals3d.surface_normals(pred_sdf_g, surface_pred, view_inv_rot)
        color01 = (pred_color + 1.0) * 0.5 if flags.pred_color else None
        semantic_grid = (pred_sem if flags.pred_semantic
                         else torch.full(pred_sdf_g.shape + (14,), 14.0, device=self.device))
        rc_pred = raycast(pred_sdf_g, surface_pred, color01, pred_normals, semantic_grid,
                          view, intr, rc)

        normals_in = _sanitize(rc_in.normal)
        if flags.pred_color:
            input2d = torch.cat([_sanitize(rc_in.color * 2.0 - 1.0), normals_in], dim=-1)
        else:
            input2d = normals_in

        target2d = target2d_label = invalid_c = None
        if cfg.project_targets:
            invalid_c = rc_tgt.color == NEG_INF
            if cfg.filter_proj_tgt:
                invalid_c = twod_losses.filter_proj_target(
                    rc_tgt.color, cfg.color_thresh, cfg.color_space)[..., None] | invalid_c
            t_color = torch.where(invalid_c, images_color, rc_tgt.color) * 2.0 - 1.0
            t_norm = torch.where(rc_tgt.normal == NEG_INF, images_normals, rc_tgt.normal)
            target2d = torch.cat([t_color, t_norm], dim=-1) if flags.pred_color else t_norm
            if flags.pred_semantic:
                target2d_label = sem_losses.rendered_semantic_label(rc_tgt.semantic)

        # depth L1 (train.py:634-641)
        loss_depth = twod_losses.depth_l1_loss(rc_pred.depth, images_depth, cfg.voxelsize, mesh)
        loss2d = cfg.weight_depth_loss * gate2d * loss_depth
        metrics["loss_depth"] = loss_depth

        # colour L1 (train.py:642-648)
        if flags.pred_color and cfg.weight_color_loss > 0:
            loss_color = twod_losses.color_l1_loss(rc_pred.color, images_color, weight_color,
                                                   mesh)
            loss2d = loss2d + cfg.weight_color_loss * gate2d * loss_color
            metrics["loss_color"] = loss_color

        # rendered stack and its validity (train.py:649-662)
        raycast_stack = (torch.cat([rc_pred.color, rc_pred.normal], dim=-1) if flags.pred_color
                         else rc_pred.normal)
        valid_px = raycast_stack.detach() != NEG_INF
        num_valid = pmesh.global_sum(valid_px.sum(), mesh)
        gate_numvalid = (num_valid > cfg.min_num_valid_2d).float()
        valid_patches = weight_color_disc = None
        if (self.discriminator is not None and cfg.patch_disc
                and cfg.patch_size < cfg.style_height):
            vp = self.discriminator.compute_valids(valid_px[..., -1:].float())
            valid_patches = vp[..., 0] > cfg.valid_thresh
            gate_numvalid = gate_numvalid * (
                pmesh.global_sum(valid_patches.sum(), mesh) > 0).float()
            if weight_color is not None:
                # per-patch discriminator weights from the missing-colour map
                # (train.py:657-661)
                wcd = self.discriminator.compute_valids(weight_color[..., None])
                weight_color_disc = (cfg.weight_missing_color * wcd
                                     / torch.clamp(pmesh.all_max(wcd.max(), mesh), min=1e-12))

        # style / content (train.py:663-686)
        if flags.compute_style or flags.compute_content:
            l_style, l_content = self._style_content(rc_pred.color, images_color, missing2d,
                                                     flags)
            loss2d = loss2d + gate2d * gate_numvalid * (
                cfg.weight_style_loss * l_style + cfg.weight_content_loss * l_content)
            if flags.compute_style:
                metrics["loss_style"] = l_style
            if flags.compute_content:
                metrics["loss_content"] = l_content

        # 2D semantic CE (train.py:743-747)
        if flags.pred_semantic and not cfg.pred_3d_semantic and target2d_label is not None:
            loss_sem2d = sem_losses.semantic_2d_loss(
                rc_pred.semantic, target2d_label, self.class_weights, mesh)
            loss2d = loss2d + cfg.weight_semantic_loss * gate2d * loss_sem2d
            metrics["loss_semantic"] = loss_sem2d

        # discriminator inputs (train.py:688-701)
        synth = target_img = None
        if flags.use_disc:
            tgt_stack = (torch.cat([images_color, images_normals], dim=-1) if flags.pred_color
                         else images_normals)
            synth_r, tgt_r = twod_losses.preprocess_rendered_target_images(
                raycast_stack, tgt_stack)
            if flags.pred_color:
                synth_r = _scale_color(synth_r)
            if cfg.project_targets and target2d is not None:
                tgt_r = target2d
            elif flags.pred_color:
                tgt_r = _scale_color(tgt_r)
            synth = torch.cat([input2d, synth_r], dim=-1)
            target_img = torch.cat([input2d, tgt_r], dim=-1).detach()

        # per-sample percent-pixel weights (train.py:597-632, 705-715)
        sample_weight_real = sample_weight_fake = None
        if cfg.weight_by_percent_pixels:
            if cfg.project_targets and rc_tgt is not None:
                w = 1.0 - invalid_c[..., 0].float().mean(dim=(1, 2))
                sample_weight_real = torch.clamp(w, 0.0, 0.3) / 0.3
            w = (rc_pred.color[..., 0].detach() != NEG_INF).float().mean(dim=(1, 2))
            sample_weight_fake = torch.clamp(w, 0.0, 0.3) / 0.3

        aux = dict(synth=synth, target_img=target_img, valid_patches=valid_patches,
                   # the combined gate (depth filled AND enough valid pixels), and
                   # the depth-fill gate alone (the reference's whole-batch skip)
                   gate2d=gate2d * gate_numvalid, gate_depth=gate2d,
                   sample_weight_real=sample_weight_real,
                   sample_weight_fake=sample_weight_fake, num_valid=num_valid,
                   weight_color_disc=weight_color_disc)
        return loss2d, metrics, aux

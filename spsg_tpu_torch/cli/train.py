"""Training CLI of the PyTorch port (``spsg_tpu/cli/train.py``'s flag surface,
itself the reference's, torch/train.py:32-107, flag for flag, so that run
scripts and ``args.txt`` carry over).

Examples:
  # real data (Matterport3D chunks generated by the datagen tools)
  python -m spsg_tpu_torch.cli.train --data_path ./data/chunks \
      --train_file_list filelists/train.txt --save ./logs

  # no dataset needed: synthetic chunks (smoke tests, measurements)
  python -m spsg_tpu_torch.cli.train --synthetic_chunks 64 --save ./logs

  # continue a run of the JAX package: export its checkpoint first
  python tools/export_torch_checkpoint.py run/model-epoch9 run/model-epoch9.pt
  python -m spsg_tpu_torch.cli.train --retrain run/model-epoch9.pt --save ./logs

Runs on the GPU (``--gpu N`` picks the card) unless ``--device cpu`` is given;
with no GPU and no ``--device cpu`` it raises. Checkpoints are ``torch.save``
files (``training/state.py``): ``model-epoch{e}.pt``, ``model-iter{it}-epoch{e}.pt``,
``model-preempt-iter{it}.pt``. ``--weight_style_loss`` / ``--weight_content_loss``
> 0 build the VGG19 extractor on the same device (``models/vgg.py``; its weights
from $SPSG_VGG_WEIGHTS, a packaged ``models/vgg19_conv8.npz`` or the torch hub
cache, else fixed-seed weights with a warning). ``--compute_dtype bfloat16``
trains the generator in bfloat16 (``training/step.py``). The flags that steer
the JAX package's compiler are accepted and have no effect.

``--distributed`` trains data-parallel, one process a card
(``parallel/multihost.py``): every rank runs this CLI with the same flags and
SPSG_COORDINATOR=host:port SPSG_NUM_PROCESSES=N SPSG_PROCESS_ID=i; it joins
the process group before anything touches the card and trains on
``cuda:<local rank>`` over NCCL (on the CPU over gloo with ``--device cpu``;
ranks sharing one card over gloo with ``--shared_card``). ``--batch_size`` is
the global batch. Rank 0 builds the CUDA kernels while the others wait, and
only rank 0 writes logs and checkpoints.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser()
    # data paths (reference train.py:34-40)
    parser.add_argument("--data_path", default="", help="path to data")
    parser.add_argument("--train_file_list", default="", help="file list of train data")
    parser.add_argument("--val_file_list", default="", help="file list of val data")
    parser.add_argument("--save", default="./logs", help="folder to output model checkpoints")
    parser.add_argument("--max_num_trainval_chunks", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--synthetic_chunks", type=int, default=0,
                        help="train on N synthetic chunks instead of --data_path")
    parser.add_argument("--gpu", type=int, default=0, help="index of the CUDA device to use")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="'cpu' trains on the CPU (the kernels' plain versions)")
    # model params (:42-44)
    parser.add_argument("--retrain", type=str, default="", help="checkpoint to load from")
    parser.add_argument("--retrain_disc", type=str, default="",
                        help="checkpoint to load the discriminator from "
                        "(reference train.py:43)")
    parser.add_argument("--input_dim", type=int, default=0, help="voxel dim (0 -> 128,64,64)")
    # train params (:46-78)
    parser.add_argument("--voxelsize", type=float, default=0.02)
    parser.add_argument("--no_loss_masking", dest="use_loss_masking", action="store_false")
    parser.add_argument("--truncation", type=float, default=3)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--max_epoch", type=int, default=10)
    parser.add_argument("--save_epoch", type=int, default=1)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--d_lr_factor", type=float, default=4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--num_iters_geo_only", type=int, default=1000)
    parser.add_argument("--num_iters_before_content", type=int, default=60000)
    parser.add_argument("--weight_occ_loss", type=float, default=1.0)
    parser.add_argument("--weight_depth_loss", type=float, default=1.0)
    parser.add_argument("--weight_sdf_loss", type=float, default=0.1)
    parser.add_argument("--weight_color_loss", type=float, default=1.0)
    parser.add_argument("--weight_semantic_loss", type=float, default=0.1)
    parser.add_argument("--pred_3d_semantic", type=bool, default=True)
    parser.add_argument("--color_thresh", type=int, default=15)
    parser.add_argument("--start_iter", type=int, default=0)
    parser.add_argument("--color_truncation", type=float, default=0)
    parser.add_argument("--no_color_augmentation", dest="augment_rgb_scaling", action="store_false")
    parser.add_argument("--augment_scale_min", type=float, default=0.5)
    parser.add_argument("--augment_scale_max", type=float, default=1.5)
    parser.add_argument("--color_space", type=str, default="lab", choices=["rgb", "lab"])
    parser.add_argument("--input_mask", type=int, default=1)
    parser.add_argument("--no_logweight_sdf", dest="logweight_sdf", action="store_false")
    parser.add_argument("--weight_missing_geo", type=float, default=5.0)
    parser.add_argument("--weight_missing_color", type=float, default=1.0)
    parser.add_argument("--weight_surf_geo", type=float, default=1.0)
    parser.add_argument("--no_pass_geo_feats", dest="pass_geo_feats", action="store_false")
    # 2d (:81-91)
    parser.add_argument("--weight_style_loss", type=float, default=0.0)
    parser.add_argument("--weight_content_loss", type=float, default=0.0)
    parser.add_argument("--frame_info_path", type=str, default="")
    parser.add_argument("--frame_path", type=str, default="")
    parser.add_argument("--style_width", type=int, default=320)
    parser.add_argument("--style_height", type=int, default=256)
    parser.add_argument("--randomize_frames", type=int, default=1)
    parser.add_argument("--max_num_frames", type=int, default=1,
                        help="RGB-D frames per chunk for the 2D losses")
    parser.add_argument("--subsample_tgt2d_factor", type=int, default=1,
                        help="low-pass the target frame colors by bilinear "
                        "down/up-sampling (reference train.py:89, "
                        "scene_dataloader.py:161-167)")
    parser.add_argument("--max_depth_fill_iters", type=int, default=40)
    # adversarial (:93-103)
    parser.add_argument("--weight_disc_loss", type=float, default=0.5)
    parser.add_argument("--weight_discgen_loss", type=float, default=0.005)
    parser.add_argument("--nf_disc", type=int, default=8)
    parser.add_argument("--nf_gen", type=int, default=20)
    parser.add_argument("--no_project_targets", dest="project_targets", action="store_false")
    parser.add_argument("--no_patch_disc", dest="patch_disc", action="store_false")
    parser.add_argument("--patch_size", type=int, default=96)
    parser.add_argument("--disc_loss_type", type=str, default="vanilla",
                        choices=["hinge", "vanilla", "wgan", "wgan_gp"])
    parser.add_argument("--valid_thresh", type=float, default=0.1)
    parser.add_argument("--no_filter_proj_tgt", dest="filter_proj_tgt", action="store_false")
    parser.add_argument("--weight_by_percent_pixels", action="store_true",
                        help="scale the adversarial terms by the valid-pixel "
                        "fraction (reference train.py:103, used :597,:628,:705)")
    parser.add_argument("--skip_batch_on_bad_depth", action="store_true",
                        help="exact reference parity: skip the WHOLE batch "
                        "(3D losses included) when depth holes cannot be "
                        "filled (train.py:539-541); default zeroes only the "
                        "2D terms")
    # flags of the JAX package's CLI beside the reference's
    parser.add_argument("--compute_dtype", type=str, default="",
                        help="'bfloat16': the generator computes in bfloat16 (parameters, "
                        "Adam state, heads and losses float32)")
    parser.add_argument("--cache_renders", type=int, default=0,
                        help="LRU capacity (entries, one a chunk and frame selection) of "
                        "the views that depend on the batch alone (input and target "
                        "marches, the depth chain), kept on the device; the same losses to "
                        "the bit (0 = recompute every step like the reference)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler Chrome trace of the run here")
    parser.add_argument("--no_vis", action="store_true",
                        help="skip the per-epoch mesh/PNG dumps (reference "
                        "save_predictions, train.py:789-849)")
    parser.add_argument("--distributed", action="store_true",
                        help="data-parallel over the ranks of SPSG_COORDINATOR / "
                             "SPSG_NUM_PROCESSES / SPSG_PROCESS_ID (one process a card)")
    parser.add_argument("--shared_card", action="store_true",
                        help="with --distributed: the ranks share one card and "
                             "communicate over gloo (a correctness run, not a speed-up)")
    parser.add_argument("--zslab_conv", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="z-slab rank-4 formulation for every generator "
                        "conv (kz taps fold into channels; ops/zslab_conv.py)")
    parser.add_argument("--folded_conv", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="the 5x5x5 generator convs, which the JAX package "
                        "folds into matmuls, as z-slab convs (ops/zslab_conv.py)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the generator's conv blocks in the backward "
                        "(less activation memory for more work)")
    for flag in ("channels_first", "pair_raycast", "compact_global", "fused_conv",
                 "pallas_conv", "compact_resid"):
        parser.add_argument(f"--{flag}", action=argparse.BooleanOptionalAction, default=False,
                            help="accepted for compatibility with the JAX package's CLI; "
                            "no effect")
    for flag, default in (("march_group", 0), ("steps_per_call", 1)):
        parser.add_argument(f"--{flag}", type=int, default=default,
                            help="accepted for compatibility with the JAX package's CLI; "
                            "no effect")
    parser.set_defaults(
        logweight_sdf=True, use_loss_masking=True, augment_rgb_scaling=True,
        pass_geo_feats=True, project_targets=True, patch_disc=True, filter_proj_tgt=True,
    )
    return parser


def config_from_args(args):
    from ..training import TrainConfig

    input_dim = (128, 64, 64) if args.input_dim == 0 else (args.input_dim,) * 3
    return TrainConfig(
        input_dim=input_dim,
        voxelsize=args.voxelsize,
        truncation=args.truncation,
        batch_size=args.batch_size,
        use_loss_masking=args.use_loss_masking,
        color_space=args.color_space,
        input_mask=bool(args.input_mask),
        augment_rgb_scaling=args.augment_rgb_scaling,
        augment_scale_min=args.augment_scale_min,
        augment_scale_max=args.augment_scale_max,
        color_truncation=args.color_truncation,
        color_thresh=args.color_thresh,
        nf_gen=args.nf_gen,
        nf_disc=args.nf_disc,
        pass_geo_feats=args.pass_geo_feats,
        lr=args.lr,
        d_lr_factor=args.d_lr_factor,
        weight_decay=args.weight_decay,
        max_epoch=args.max_epoch,
        save_epoch=args.save_epoch,
        num_iters_geo_only=args.num_iters_geo_only,
        num_iters_before_content=args.num_iters_before_content,
        weight_occ_loss=args.weight_occ_loss,
        weight_sdf_loss=args.weight_sdf_loss,
        weight_depth_loss=args.weight_depth_loss,
        weight_color_loss=args.weight_color_loss,
        weight_semantic_loss=args.weight_semantic_loss,
        pred_3d_semantic=args.pred_3d_semantic,
        weight_missing_geo=args.weight_missing_geo,
        weight_surf_geo=args.weight_surf_geo,
        weight_missing_color=args.weight_missing_color,
        weight_style_loss=args.weight_style_loss,
        weight_content_loss=args.weight_content_loss,
        weight_disc_loss=args.weight_disc_loss,
        weight_discgen_loss=args.weight_discgen_loss,
        logweight_sdf=args.logweight_sdf,
        project_targets=args.project_targets,
        filter_proj_tgt=args.filter_proj_tgt,
        style_width=args.style_width,
        style_height=args.style_height,
        max_depth_fill_iters=args.max_depth_fill_iters,
        patch_disc=args.patch_disc,
        patch_size=args.patch_size,
        disc_loss_type=args.disc_loss_type,
        valid_thresh=args.valid_thresh,
        weight_by_percent_pixels=args.weight_by_percent_pixels,
        skip_batch_on_bad_depth=args.skip_batch_on_bad_depth,
        compute_dtype=args.compute_dtype or None,
        channels_first=args.channels_first,
        pallas_conv=args.pallas_conv,
        fused_conv=args.fused_conv,
        folded_conv=args.folded_conv,
        zslab_conv=args.zslab_conv,
        pair_raycast=args.pair_raycast,
        compact_across_batch=args.compact_global,
        march_group=args.march_group,
        remat=args.remat,
        compact_resid=args.compact_resid,
        cache_renders=args.cache_renders,
    )


class SyntheticChunkDataset:
    """In-memory synthetic chunk dataset (no Matterport download needed); with
    frames, each chunk's frame is rendered on ``device``."""

    def __init__(self, n, cfg, with_frames, seed=0, device="cuda"):
        from ..data import synthetic

        self.samples = []
        for i in range(n):
            b = synthetic.make_chunk_batch(
                batch_size=1,
                dims=cfg.input_dim,
                image_dims=(cfg.style_width, cfg.style_height),
                seed=seed * 100000 + i,
                with_frames=with_frames,
                truncation=cfg.truncation,
                device=device,
            )
            sample = {k: (v[0] if isinstance(v, np.ndarray) else v) for k, v in b.items()}
            sample["name"] = f"synthetic_{i}"
            self.samples.append(sample)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def main(argv=None):
    """Parse ``argv``, train, and return the loop's ``TrainResult``. With
    ``--distributed`` the process leaves the process group when it returns."""
    args = build_parser().parse_args(argv)
    import torch.distributed as dist

    from ..parallel import make_mesh, multihost

    mesh = None
    if args.distributed:
        # before anything touches the card (launch recipe: parallel/multihost.py)
        device = multihost.initialize(device_type=args.device, shared_card=args.shared_card)
        try:
            mesh = make_mesh(device)
            print(f"distributed: process {mesh.rank}/{mesh.size}, device {device}, "
                  f"backend {dist.get_backend()}")
            if device.type == "cuda":
                multihost.build_kernels(mesh)
            return _main(args, device, mesh)
        finally:
            multihost.shutdown()
    from ..training.state import resolve_device

    return _main(args, resolve_device("cpu" if args.device == "cpu" else f"cuda:{args.gpu}"),
                 mesh)


def _main(args, device, mesh):
    from ..parallel import multihost
    from ..training.loop import run_training
    from ..utils.logging import dump_args
    from ..utils.timing import torch_trace

    cfg = config_from_args(args)
    os.makedirs(args.save, exist_ok=True)
    if multihost.is_primary():
        dump_args(args, os.path.join(args.save, "args.txt"))
    print(args)

    with_frames = cfg.weight_depth_loss > 0 or cfg.weight_disc_loss > 0
    if args.synthetic_chunks > 0:
        train_ds = SyntheticChunkDataset(args.synthetic_chunks, cfg, with_frames, seed=1,
                                         device=device)
        val_ds = SyntheticChunkDataset(max(2, args.synthetic_chunks // 8), cfg, with_frames,
                                       seed=2, device=device)
    else:
        from ..data.pipeline import ChunkDataset, get_train_files

        train_files, val_files, overfit = get_train_files(
            args.data_path, args.train_file_list, args.val_file_list,
            args.max_num_trainval_chunks,
        )
        if overfit:
            # reference overfit mode (train.py:179-183)
            import dataclasses

            cfg = dataclasses.replace(cfg, use_loss_masking=False)
            print("overfit -> no loss masking")
        kw = dict(
            truncation=cfg.truncation,
            color_space=cfg.color_space,
            augment_hue=cfg.augment_rgb_scaling,
            aug_scale_range=(cfg.augment_scale_min, cfg.augment_scale_max),
            color_truncation=cfg.color_truncation,
            load_semantic=cfg.weight_semantic_loss > 0,
            frame_info_path=args.frame_info_path,
            frame_path=args.frame_path,
            image_dims=(cfg.style_width, cfg.style_height),
            load_depth=cfg.weight_depth_loss > 0,
            randomize_frames=bool(args.randomize_frames),
            max_num_frames=args.max_num_frames,
            subsamp2d_factor=args.subsample_tgt2d_factor,
            input_dim=cfg.input_dim,
        )
        train_ds = ChunkDataset(train_files, num_overfit=40 if overfit else 0, **kw)
        val_ds = ChunkDataset(val_files, num_overfit=160 if overfit else 0, **kw) if val_files else None
        print("#train files =", len(train_ds))

    vgg = None
    if cfg.weight_style_loss > 0 or cfg.weight_content_loss > 0:
        from ..models.vgg import load_vgg_for_style

        vgg = load_vgg_for_style(device=device)

    with torch_trace(args.profile_dir or None):
        return run_training(
            cfg,
            train_ds,
            val_ds,
            save_dir=args.save,
            start_epoch=args.start_epoch,
            start_iter=args.start_iter,
            retrain=args.retrain,
            retrain_disc=args.retrain_disc,
            vis_at_epoch_end=not args.no_vis,
            device=device,
            vgg=vgg,
            mesh=mesh,
        )


if __name__ == "__main__":
    main()

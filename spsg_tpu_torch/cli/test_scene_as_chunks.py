"""Whole-scene chunked evaluation CLI (reference
torch/test_scene_as_chunks.py:21-371): sliding-window completion with overlap
stitching, global geo IoU + per-class/frequency-weighted semantic mIoU,
IoU.txt, and mesh/image visual dumps. Same flags as the JAX package's CLI.

Examples:
  python -m spsg_tpu_torch.cli.test_scene_as_chunks --input_data_path ./scenes-inc \
      --target_data_path ./scenes-cmp --test_file_list filelists/test.txt \
      --model_path ./logs/model-epoch9.pt --output ./output

  python -m spsg_tpu_torch.cli.test_scene_as_chunks --synthetic_scenes 3 \
      --model_path '' --output ./output      # random weights, smoke mode

Runs on the GPU (``--gpu N`` picks the card) unless ``--device cpu`` is given;
with no GPU and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--gpu", type=int, default=0, help="index of the CUDA device to use")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cpu' runs everything (kernels' plain versions included) on the CPU")
    p.add_argument("--input_data_path", default="", help="path to input scenes")
    p.add_argument("--target_data_path", default="", help="path to target scenes")
    p.add_argument("--test_file_list", default="", help="file list of test scenes")
    p.add_argument("--model_path", default="",
                   help="checkpoint to test: .pt of this package or .pth of the reference "
                   "('' = random init); convert a JAX checkpoint with "
                   "tools/export_torch_checkpoint.py")
    p.add_argument("--output", default="./output", help="output folder")
    p.add_argument("--synthetic_scenes", type=int, default=0)
    p.add_argument("--truncation", type=float, default=3)
    p.add_argument("--input_dim", type=int, default=0)
    p.add_argument("--nf_gen", type=int, default=20)
    p.add_argument("--no_pass_geo_feats", dest="pass_geo_feats", action="store_false")
    p.add_argument("--input_mask", type=int, default=1)
    p.add_argument("--num_to_vis", type=int, default=10)
    p.add_argument("--max_to_process", type=int, default=150)
    p.add_argument("--vis_only", action="store_true",
                   help="overwrite an existing --output without prompting "
                   "(reference test_scene_as_chunks.py:354-358; this CLI "
                   "never prompts, so the flag only suppresses the cleanup)")
    p.add_argument("--weight_color_loss", type=float, default=1.0)
    p.add_argument("--weight_semantic_loss", type=float, default=0.1)
    p.add_argument("--color_thresh", type=float, default=15.0)
    p.add_argument("--color_truncation", type=float, default=0,
                   help="zero input colors farther than this many voxels "
                   "from the surface (reference :43)")
    p.add_argument("--augment_rgb_scaling", action="store_true")
    p.add_argument("--augment_scale_min", type=float, default=0.5)
    p.add_argument("--augment_scale_max", type=float, default=1.5)
    p.add_argument("--color_space", type=str, default="lab")
    p.add_argument("--stride", type=int, default=32)
    p.add_argument("--window_batch", type=int, default=8)
    p.add_argument("--compact_feed", action="store_true",
                   help="feed raw f32-sdf + u8-rgb to the device and run clamp/LAB/mask "
                   "there; incompatible with --augment_rgb_scaling")
    p.add_argument("--compute_dtype", type=str, default="",
                   help="'bfloat16' runs the generator's blocks in bf16 (the heads in f32)")
    p.add_argument("--zslab_conv", action="store_true",
                   help="z-slab rank-4 conv formulation (ops/zslab_conv.py)")
    p.add_argument("--folded_conv", action="store_true",
                   help="the 5x5x5 entry convs, which the JAX package folds into "
                   "matmuls, as z-slab convs (ops/zslab_conv.py)")
    # flags that steer the JAX package's compiler; accepted, without effect here
    for flag in ("--scan_windows", "--stitch_slices"):
        p.add_argument(flag, action="store_true",
                       help="accepted for compatibility with the JAX package's CLI; no effect")
    p.set_defaults(pass_geo_feats=True)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.compact_feed and args.augment_rgb_scaling:
        raise SystemExit(
            "--compact_feed assembles the sample on the device and does not "
            "implement hue augmentation; drop --augment_rgb_scaling")
    import torch

    from ..data import category
    from ..inference import chunked
    from ..training import TrainConfig
    from ..training.state import init_generator, load_any_checkpoint, resolve_device
    from ..utils import visualize

    device = resolve_device("cpu" if args.device == "cpu" else f"cuda:{args.gpu}")
    chunk_dims = (128, 64, 64) if args.input_dim == 0 else (args.input_dim,) * 3
    cfg = TrainConfig(
        input_dim=chunk_dims,
        truncation=args.truncation,
        nf_gen=args.nf_gen,
        pass_geo_feats=args.pass_geo_feats,
        input_mask=bool(args.input_mask),
        color_space=args.color_space,
        weight_color_loss=args.weight_color_loss,
        weight_semantic_loss=args.weight_semantic_loss,
        weight_disc_loss=0.0,
        compute_dtype=args.compute_dtype or None,
        folded_conv=args.folded_conv,
        zslab_conv=args.zslab_conv,
    )
    generator = init_generator(cfg, torch.Generator().manual_seed(0), device)
    if args.model_path:
        generator, _ = load_any_checkpoint(args.model_path, generator)
        print("loaded model:", args.model_path)

    # scene iteration is STREAMED — one scene's arrays in host RAM at a time
    # (the reference iterates the dataloader the same way,
    # test_scene_as_chunks.py:111)
    if args.synthetic_scenes > 0:
        from ..data import pipeline, synthetic

        scene_dims = (chunk_dims[0], chunk_dims[1] * 5 // 2, chunk_dims[2] * 3)

        def _iter_scenes():
            for i in range(args.synthetic_scenes):
                s = synthetic.make_scene(dims=scene_dims, seed=100 + i)
                sample = pipeline.assemble_sample(
                    s.sdf_input, s.sdf_complete, s.input_colors, s.colors,
                    s.semantics, s.known, s.world2grid, args.truncation,
                    args.color_space, None,
                )
                sample["name"] = f"synthetic_scene_{i}"
                if args.compact_feed:
                    sample["raw_sdf_input"] = s.sdf_input.astype(np.float32)
                    sample["raw_input_colors"] = s.input_colors
                yield sample

        num_scenes = args.synthetic_scenes
    else:
        from ..data import pipeline

        files, _, _ = pipeline.get_train_files(args.input_data_path, args.test_file_list)
        random.seed(42)
        random.shuffle(files)
        files = files[: args.max_to_process]
        ds = pipeline.SceneDataset(
            files,
            args.target_data_path,
            truncation=args.truncation,
            color_space=args.color_space,
            load_semantic=args.weight_semantic_loss > 0,
            color_truncation=args.color_truncation,
            augment_hue=args.augment_rgb_scaling,
            aug_scale_range=(args.augment_scale_min, args.augment_scale_max),
            keep_raw=args.compact_feed,
        )

        def _iter_scenes():
            for i in range(len(ds)):
                yield ds[i]

        num_scenes = len(ds)

    os.makedirs(args.output, exist_ok=True)
    vis_dir = os.path.join(args.output, "vis")
    os.makedirs(vis_dir, exist_ok=True)

    geo_i_total = 0
    geo_u_total = 0
    cls_i_total = np.zeros(category.NUM_CLASSES, np.int64)
    cls_u_total = np.zeros(category.NUM_CLASSES, np.int64)
    cls_w_total = np.zeros(category.NUM_CLASSES, np.int64)
    num_vis = 0
    for si, sample in enumerate(_iter_scenes()):
        print(f"[ {si} | {num_scenes} ] {sample['name']} {sample['input'].shape}")
        compact = None
        if args.compact_feed:
            compact = dict(sdf=sample["raw_sdf_input"], colors=sample["raw_input_colors"],
                           color_space=args.color_space)
        out = chunked.run_chunked_inference(
            generator,
            None if compact is not None else sample["input"],
            None if compact is not None else sample["mask"],
            sample["target_sdf"],
            sample.get("known"),
            sample.get("semantics"),
            compact_scene=compact,
            truncation=args.truncation,
            chunk_dims=chunk_dims,
            stride=args.stride,
            window_batch=args.window_batch,
            pred_color=args.weight_color_loss > 0,
            pred_semantic=args.weight_semantic_loss > 0,
            device=device,
        )
        summ = chunked.summarize_iou(
            out.geo_intersection, out.geo_union,
            out.class_intersection, out.class_union, out.class_weight,
        )
        print(f"**Geo IoU: {summ['geo_iou']:.3f}  mean mIoU: {summ['mean_iou']:.3f}")
        geo_i_total += out.geo_intersection
        geo_u_total += out.geo_union
        cls_i_total += out.class_intersection
        cls_u_total += out.class_union
        cls_w_total += out.class_weight

        if num_vis < args.num_to_vis:
            pred_colors01 = (
                out.colors / 255.0 * 2.0 - 1.0 if out.colors is not None else None
            )
            visualize.save_predictions(
                vis_dir,
                sample["name"],
                sample["input"][: out.sdf.shape[0]],
                np.clip(sample["target_sdf"][: out.sdf.shape[0]], -args.truncation, args.truncation),
                sample["target_colors"][: out.sdf.shape[0]],
                sample["semantics"][: out.sdf.shape[0]] if "semantics" in sample else None,
                out.sdf,
                pred_colors01,
                out.sem_labels,
                truncation=args.truncation,
                color_space=args.color_space,
            )
            num_vis += 1

    print("\n=========== Summary =============")
    summary = chunked.summarize_iou(
        geo_i_total, geo_u_total, cls_i_total, cls_u_total, cls_w_total
    )
    print(f"Evaluate {num_scenes} regions:")
    print(f"**Geo IoU: {summary['geo_iou']:.3f}")
    for n, v in summary["class_iou"].items():
        print(f"{n}: {v:.3f}")
    print(f"**Mean: {summary['mean_iou']:.3f}")
    chunked.write_iou_txt(os.path.join(args.output, "IoU.txt"), summary)
    return summary


if __name__ == "__main__":
    main()

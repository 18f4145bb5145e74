"""Mesh / image metrics CLI of the PyTorch port (``spsg_tpu/cli/metrics.py``'s
flags, plus ``--device``; reference torch/metrics.py:16-104): Chamfer distance
and voxelised IoU / recall between predicted and target meshes, SSIM and
Feature-l1 between rendered and target image pairs, FID between two image sets.

  python -m spsg_tpu_torch.cli.metrics --metric chamfer \
      --pred_dir out/vis --target_dir out/vis --pred_suffix _pred-mesh.ply \
      --target_suffix _target-mesh.ply
  python -m spsg_tpu_torch.cli.metrics --metric ssim --pred_dir out/vis \
      --target_dir out/vis --pred_suffix _pred.png --target_suffix _target.png

Feature-l1 and FID run Inception-v3 on the GPU (``--gpu N`` picks the card)
unless ``--device cpu`` is given; with no GPU and no ``--device cpu`` they
raise. The mesh metrics and SSIM are host numpy / scipy. ``main`` returns what
it printed: ``{"fid": value, ...}``, or ``{"results": [(name, value)],
"mean": value}``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument(
        "--metric", choices=["chamfer", "iou", "ssim", "feature_l1", "fid"],
        required=True
    )
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--target_dir", required=True)
    p.add_argument("--pred_suffix", default="_pred-mesh.ply")
    p.add_argument("--target_suffix", default="_target-mesh.ply")
    p.add_argument("--num_samples", type=int, default=30000)
    p.add_argument("--voxel_size", type=float, default=0.02,
                   help="voxel size for --metric iou (reference metrics.py:35)")
    p.add_argument("--output", default="", help="optional txt file for results")
    p.add_argument(
        "--inception_v3_path", default="",
        help="torchvision inception_v3 .pth for Feature-l1/FID features "
        "(reference metrics.py:37; random fixed-seed features when absent)",
    )
    p.add_argument("--gpu", type=int, default=0, help="index of the CUDA device to use")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cpu' runs Inception-v3 on the CPU")
    args = p.parse_args(argv)

    from ..inference import metrics as M
    from ..ops import mesh
    from ..training.state import resolve_device

    device = resolve_device("cpu" if args.device == "cpu" else f"cuda:{args.gpu}")
    if args.inception_v3_path:
        M.set_inception_path(args.inception_v3_path)

    names = sorted(
        f[: -len(args.pred_suffix)]
        for f in os.listdir(args.pred_dir)
        if f.endswith(args.pred_suffix)
    )

    if args.metric == "fid":
        # set-level metric: Frechet distance between the pred and target
        # image distributions (the reference delegates FID to the external
        # TTUR repo, metrics.py:7; self-contained here)
        from PIL import Image

        def load_set(d, suffix):
            imgs = []
            for f in sorted(os.listdir(d)):
                if f.endswith(suffix):
                    imgs.append(np.array(Image.open(os.path.join(d, f)).convert("RGB")) / 255.0)
            return imgs

        pred_imgs = load_set(args.pred_dir, args.pred_suffix)
        tgt_imgs = load_set(args.target_dir, args.target_suffix)
        if len(pred_imgs) < 2 or len(tgt_imgs) < 2:
            print("fid needs >= 2 images per set")
            return {}
        val = M.fid(M.image_features(pred_imgs, device), M.image_features(tgt_imgs, device))
        print(f"fid over {len(pred_imgs)} pred / {len(tgt_imgs)} target images: {val:.6f}")
        if args.output:
            with open(args.output, "w") as f:
                f.write(f"fid {val}\n")
        return {"fid": val, "pred_images": len(pred_imgs), "target_images": len(tgt_imgs)}

    results = []
    for name in names:
        pred_path = os.path.join(args.pred_dir, name + args.pred_suffix)
        tgt_path = os.path.join(args.target_dir, name + args.target_suffix)
        if not os.path.isfile(tgt_path):
            continue
        if args.metric == "chamfer":
            pv, _, pf = mesh.load_ply(pred_path)
            tv, _, tf = mesh.load_ply(tgt_path)
            if len(pf) == 0 or len(tf) == 0:
                continue
            val = M.chamfer_between_meshes(pv, pf, tv, tf, args.num_samples)
        elif args.metric == "iou":
            # voxelized surface IoU + Recall — the reference's own unfinished
            # metric (metrics.py:64 TODO), completed here
            pv, _, pf = mesh.load_ply(pred_path)
            tv, _, tf = mesh.load_ply(tgt_path)
            if len(pf) == 0 or len(tf) == 0:
                continue
            val, recall = M.mesh_iou_recall(pv, pf, tv, tf, args.voxel_size)
            print(f"{name}: recall {recall:.6f}")
        else:
            from PIL import Image

            a = np.array(Image.open(pred_path).convert("RGB"))
            b = np.array(Image.open(tgt_path).convert("RGB"))
            if args.metric == "ssim":
                val = M.ssim(a, b)
            else:
                val = M.feature_l1(a / 255.0, b / 255.0, device)
        results.append((name, val))
        print(f"{name}: {val:.6f}")

    mean = None
    if results:
        mean = float(np.mean([v for _, v in results]))
        print(f"mean {args.metric} over {len(results)}: {mean:.6f}")
        if args.output:
            with open(args.output, "w") as f:
                for n, v in results:
                    f.write(f"{n} {v}\n")
                f.write(f"mean {mean}\n")
    else:
        print("no matching pairs found")
    return {"results": results, "mean": mean}


if __name__ == "__main__":
    main()

"""Single-shot whole-scene inference + top-down raycast visualization CLI
(PyTorch counterpart of ``spsg_tpu/cli/test_scene.py``; reference
torch/test_scene.py:24-380): pads the scene to a multiple of 4, runs the
fully-convolutional generator once at full scene size
(``inference/whole_scene.py``), then renders input / target / prediction views
from a synthetic overhead camera with the raycaster, dumping meshes and
images. Same flags as the JAX package's CLI, plus ``--device``.

Examples:
  python -m spsg_tpu_torch.cli.test_scene --input_data_path ./scenes-inc \\
      --target_data_path ./scenes-cmp --test_file_list filelists/test.txt \\
      --model_path ./model.pth --output ./output_scene

  python -m spsg_tpu_torch.cli.test_scene --synthetic_scenes 1 \\
      --model_path '' --output ./output_scene      # random weights, smoke mode

Runs on the GPU (``--gpu N`` picks the card) unless ``--device cpu`` (or
``--cpu``) is given; with no GPU and no ``--device cpu`` it raises.
``--model_path`` takes a checkpoint of this package (``.pt``) or of the
original PyTorch reference (``.pth``).

``--spatial_shard`` splits each scene along Y over the ranks of a process
group (``inference/whole_scene.py``): launched as N processes with
SPSG_COORDINATOR=host:port SPSG_NUM_PROCESSES=N SPSG_PROCESS_ID=i (one card
each over NCCL; the CPU over gloo with ``--device cpu``), the CLI joins the
group first; without those variables it is a world of one. Y is padded to a multiple of ``4 * N``, as in
the JAX package. Every rank runs its slab; rank 0 renders and writes.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--gpu", type=int, default=0, help="index of the CUDA device to use")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cpu' runs everything (kernels' plain versions included) on the CPU")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu "
                   "(reference test_scene.py --cpu)")
    p.add_argument("--input_data_path", default="")
    p.add_argument("--target_data_path", default="")
    p.add_argument("--test_file_list", default="")
    p.add_argument("--model_path", default="",
                   help="checkpoint to test: .pt of this package or .pth of the reference "
                   "('' = random init)")
    p.add_argument("--output", default="./output_scene")
    p.add_argument("--synthetic_scenes", type=int, default=0)
    p.add_argument("--truncation", type=float, default=3)
    p.add_argument("--voxelsize", type=float, default=0.02)
    p.add_argument("--input_dim", type=int, nargs=3, default=None,
                   metavar=("Z", "Y", "X"),
                   help="max scene bounds to load (reference test_scene.py:63 "
                   "default (128, 260, 328)); the forward pass here is "
                   "shape-polymorphic so this only bounds loading")
    p.add_argument("--nf_gen", type=int, default=20)
    p.add_argument("--no_pass_geo_feats", dest="pass_geo_feats", action="store_false")
    p.add_argument("--input_mask", type=int, default=1)
    p.add_argument("--max_input_height", type=int, default=128)
    p.add_argument("--compute_dtype", type=str, default="",
                   help="'bfloat16' runs the generator's blocks in bf16 (the heads in f32)")
    p.add_argument("--zslab_conv", action="store_true",
                   help="z-slab rank-4 conv formulation (ops/zslab_conv.py)")
    p.add_argument("--folded_conv", action="store_true",
                   help="the 5x5x5 entry convs, which the JAX package folds into "
                   "matmuls, as z-slab convs (ops/zslab_conv.py)")
    p.add_argument("--num_to_vis", type=int, default=10)
    p.add_argument("--max_to_process", type=int, default=150)
    p.add_argument("--vis_only", action="store_true",
                   help="overwrite an existing --output without prompting "
                   "(reference test_scene.py:43; this CLI never prompts)")
    p.add_argument("--weight_color_loss", type=float, default=1.0)
    p.add_argument("--weight_semantic_loss", type=float, default=0.1)
    p.add_argument("--color_thresh", type=float, default=15.0)
    p.add_argument("--color_truncation", type=float, default=0)
    p.add_argument("--augment_rgb_scaling", action="store_true")
    p.add_argument("--augment_scale_min", type=float, default=0.5)
    p.add_argument("--augment_scale_max", type=float, default=1.5)
    p.add_argument("--color_space", type=str, default="lab")
    p.add_argument("--style_width", type=int, default=480)  # reference test_scene.py:58
    p.add_argument("--style_height", type=int, default=384)
    p.add_argument("--spatial_shard", action="store_true",
                   help="shard the scene volume along Y over the ranks of the process group")
    p.set_defaults(pass_geo_feats=True)
    return p


def overhead_camera(dims_zyx, width, height):
    """The reference's fly-over camera (test_scene.py:89-95, 182-187):
    fx/fy = 269.112/269.297, looking straight down from 2x the scene height
    above the scene center. Returns (cam2grid (4,4), intrinsics (4,))."""
    intr = np.array([269.1120, 269.2970, width // 2, height // 2], np.float32)
    cam2grid = np.array(
        [
            [1, 0, 0, dims_zyx[2] // 2],
            [0, -1, 0, dims_zyx[1] // 2],
            [0, 0, -1, dims_zyx[0] * 2],
            [0, 0, 0, 1],
        ],
        np.float32,
    )
    return cam2grid, intr


def render_views(sdf, valid, colors01, semantics_grid, view, intr, cfg_rc, device="cuda"):
    """Raycast one volume from the overhead camera on ``device``: the surface
    normals of the SDF (``ops/normals3d.py``), the march and the shade
    (``ops/raycast.py``; K4 and K5 on a card). ``sdf`` (Z,Y,X), ``valid``,
    ``colors01`` (Z,Y,X,3) or None and ``semantics_grid`` (Z,Y,X,14) or None
    are numpy arrays or tensors. Returns a dict of numpy images
    (color/normal/depth/semantic-label)."""
    import torch

    from ..losses import semantic as sem_losses
    from ..ops import normals3d
    from ..ops.raycast import raycast

    def dev(a):
        if a is None:
            return None
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device)[None].contiguous()

    view_inv_rot = np.linalg.inv(view)[None, :3, :3].astype(np.float32)
    with torch.no_grad():
        s, v = dev(sdf), dev(valid)
        out = raycast(s, v, dev(colors01),
                      normals3d.surface_normals(s, v, torch.from_numpy(view_inv_rot).to(device)),
                      dev(semantics_grid), torch.from_numpy(view[None]).to(device),
                      torch.from_numpy(intr[None]).to(device), cfg_rc)
        images = {
            "color": out.color[0].cpu().numpy(),
            "normal": out.normal[0].cpu().numpy(),
            "depth": out.depth[0].cpu().numpy(),
        }
        if semantics_grid is not None:
            images["semlabel"] = sem_losses.rendered_semantic_label(out.semantic)[0].cpu().numpy()
    return images


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..parallel import make_mesh, multihost

    cpu = args.cpu or args.device == "cpu"
    if args.spatial_shard and os.environ.get("SPSG_COORDINATOR"):
        # before anything touches the card (launch recipe: parallel/multihost.py)
        device = multihost.initialize(device_type="cpu" if cpu else "cuda")
        try:
            mesh = make_mesh(device)
            print(f"spatial shard: process {mesh.rank}/{mesh.size}, device {device}")
            if device.type == "cuda":
                multihost.build_kernels(mesh)
            return _main(args, device, mesh)
        finally:
            multihost.shutdown()
    from ..training.state import resolve_device

    device = resolve_device("cpu" if cpu else f"cuda:{args.gpu}")
    return _main(args, device, make_mesh(device) if args.spatial_shard else None)


def _main(args, device, mesh):
    import torch
    import torch.nn.functional as F

    from ..data import pipeline
    from ..inference import whole_scene
    from ..ops.raycast import RaycastConfig
    from ..training import TrainConfig
    from ..training.state import init_generator, load_any_checkpoint
    from ..utils import visualize

    primary = mesh is None or mesh.rank == 0
    n_shards = mesh.size if mesh is not None else 1
    cfg = TrainConfig(
        truncation=args.truncation,
        nf_gen=args.nf_gen,
        pass_geo_feats=args.pass_geo_feats,
        input_mask=bool(args.input_mask),
        color_space=args.color_space,
        weight_disc_loss=0.0,
        compute_dtype=args.compute_dtype or None,
        folded_conv=args.folded_conv,
        zslab_conv=args.zslab_conv,
    )
    generator = init_generator(cfg, torch.Generator().manual_seed(0), device)
    if args.model_path:
        generator, _ = load_any_checkpoint(args.model_path, generator)
        print("loaded model:", args.model_path)

    # streamed: one scene's arrays in host RAM at a time (matches the
    # reference's dataloader iteration, test_scene.py:110)
    if args.synthetic_scenes > 0:
        from ..data import synthetic

        def _iter_scenes():
            for i in range(args.synthetic_scenes):
                s = synthetic.make_scene(dims=(128, 160, 192), seed=200 + i)
                sample = pipeline.assemble_sample(
                    s.sdf_input, s.sdf_complete, s.input_colors, s.colors,
                    s.semantics, s.known, s.world2grid, args.truncation,
                    args.color_space, None,
                )
                sample["name"] = f"synthetic_scene_{i}"
                yield sample

    else:
        files, _, _ = pipeline.get_train_files(args.input_data_path, args.test_file_list)
        files = files[: args.max_to_process]
        ds = pipeline.SceneDataset(
            files, args.target_data_path, truncation=args.truncation,
            color_space=args.color_space, load_semantic=args.weight_semantic_loss > 0,
            color_truncation=args.color_truncation,
            augment_hue=args.augment_rgb_scaling,
            aug_scale_range=(args.augment_scale_min, args.augment_scale_max),
        )

        def _iter_scenes():
            for i in range(len(ds)):
                yield ds[i]

    os.makedirs(args.output, exist_ok=True)
    rc = RaycastConfig(
        width=args.style_width,
        height=args.style_height,
        depth_min=0.1 / args.voxelsize,
        depth_max=6.0 / args.voxelsize,
        ray_increment=0.3 * args.truncation,
        thresh_sample_dist=50.5 * 0.3 * args.truncation,
    )

    for si, sample in enumerate(_iter_scenes()):
        if si >= args.max_to_process:
            break
        name = sample["name"]
        inp = sample["input"]
        mask = sample["mask"]
        if args.input_dim is not None:
            # bound loaded scene extents (reference max_data_size crop,
            # test_scene.py:63,78)
            z, y, x = args.input_dim
            inp = inp[:z, :y, :x]
            mask = mask[:z, :y, :x] if mask is not None else None
        pad_inp, pad_mask, dims = whole_scene.pad_scene(
            inp, mask, args.truncation, args.max_input_height, y_multiple=4 * n_shards)
        print(f"[ {si} ] {name} {tuple(dims)}")

        _, sdf_p, color_p, sem_p = whole_scene.run_whole_scene(
            generator, inp, mask,
            truncation=args.truncation, max_height=args.max_input_height,
            pred_color=args.weight_color_loss > 0,
            pred_semantic=args.weight_semantic_loss > 0, mesh=mesh, device=device,
        )
        pred_valid = np.abs(sdf_p) < args.truncation  # test_scene.py:156

        if si < args.num_to_vis and primary:
            view, intr = overhead_camera(tuple(dims), args.style_width, args.style_height)
            images = {}
            # input render
            in_sdf = pad_inp[..., 0]
            r = render_views(in_sdf, np.abs(in_sdf) < args.truncation,
                             pad_inp[..., 1:4], None, view, intr, rc, device)
            images["input"] = r["color"]
            images["input-normals"] = r["normal"]
            # target render
            tz = min(dims[0], sample["target_sdf"].shape[0])
            tgt = np.full(tuple(dims), np.inf, np.float32)
            tgt[:tz, : sample["target_sdf"].shape[1], : sample["target_sdf"].shape[2]] = np.clip(
                sample["target_sdf"][:tz], -args.truncation, args.truncation
            )
            tcol = np.zeros(tuple(dims) + (3,), np.float32)
            tcol[:tz, : sample["target_colors"].shape[1], : sample["target_colors"].shape[2]] = (
                sample["target_colors"][:tz] / 255.0
            )
            tsem = None
            s14 = None
            if "semantics" in sample:
                s14 = np.full(tuple(dims), 14, np.uint8)
                s14[:tz, : sample["semantics"].shape[1], : sample["semantics"].shape[2]] = sample[
                    "semantics"
                ][:tz]
                # the 15-way one-hot of the labels, unlabeled (14) dropped
                tsem = F.one_hot(torch.from_numpy(s14).to(device).long(), 15)[..., :14].float()
            r = render_views(np.where(np.isfinite(tgt), tgt, args.truncation),
                             np.abs(tgt) < args.truncation, tcol, tsem, view, intr, rc, device)
            images["target"] = r["color"]
            images["target-normals"] = r["normal"]
            images["target-depth"] = np.where(np.isfinite(r["depth"]), r["depth"] * args.voxelsize, 0)
            if "semlabel" in r:
                images["target-semantics"] = r["semlabel"]
            # prediction render
            pcol01 = (color_p + 1.0) * 0.5 if color_p is not None else None
            r = render_views(sdf_p, pred_valid, pcol01, sem_p, view, intr, rc, device)
            images["pred"] = r["color"]
            images["pred-normals"] = r["normal"]
            images["pred-depth"] = np.where(np.isfinite(r["depth"]), r["depth"] * args.voxelsize, 0)
            if "semlabel" in r:
                images["pred-semantics"] = r["semlabel"]

            visualize.save_predictions(
                args.output,
                name,
                pad_inp,
                np.where(np.isfinite(tgt), tgt, -np.inf),
                None,
                s14,
                np.where(pred_valid, sdf_p, -np.inf),
                color_p,
                sem_p,
                truncation=args.truncation,
                color_space=args.color_space,
                images=images,
            )
    print("done")


if __name__ == "__main__":
    main()

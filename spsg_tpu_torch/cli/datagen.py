"""Dataset-generation CLI of the PyTorch port (the counterpart of
``spsg_tpu/cli/datagen.py``, flag for flag; rebuild of the reference's offline
tooling: datagen virtual scanner + torch/extend_sdfs*.py). ``scan`` and
``sens`` fuse on ``--device`` (``cuda`` unless ``--device cpu`` is given:
the TSDF integrate runs as hand kernel K8 there); the other subcommands run
on the host.

Subcommands:
  scan     — virtually scan labeled room meshes (PLY) into __inc__/__cmp__
             scene .sdf/.colors/.knw files (reference datagen app,
             Visualizer.cpp:99-219 + Fuser.cpp:21-186)
  sens     — fuse raw .sens RGB-D streams into scene files
  chunk    — cut scene files into fixed-size training chunks
  semantics— splat region-segmentation labels into __sem__ chunk files or
             standalone scene .semantics (reference extend_sdfs.py /
             extend_sdfs_2cm.py)
  category — regenerate category.npz + the class legend figure

Example (mesh -> trainable chunks with semantics):
  python -m spsg_tpu_torch.cli.datagen scan --mesh room0.ply --output_dir scans/
  python -m spsg_tpu_torch.cli.datagen chunk --inc scans/room0__inc__0 \
      --cmp scans/room0__cmp__0 --output_dir chunks/ --name room0
  python -m spsg_tpu_torch.cli.datagen semantics --region_ply room0_semseg.ply \
      --sdf_glob 'chunks/room0__cmp__*.sdf' --mapping category_mapping.tsv
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def cmd_scan(args):
    from ..datagen import fusion, scan
    from ..ops import mesh as mesh_ops

    verts, colors, faces = mesh_ops.load_ply(args.mesh)
    name = os.path.splitext(os.path.basename(args.mesh))[0]
    os.makedirs(args.output_dir, exist_ok=True)
    center = verts.mean(0)
    extent = verts.max(0) - verts.min(0)
    traj = scan.orbit_trajectory(
        center, radius=float(np.linalg.norm(extent[:2]) * 0.75),
        height=float(extent[2] * 1.2 + 0.5), num_frames=args.num_frames,
    )
    cfg = fusion.FusionConfig(voxelsize=args.voxelsize)
    sc = scan.ScanConfig(chance_drop_frames=args.chance_drop_frames)
    inc = os.path.join(args.output_dir, f"{name}__inc__0")
    cmp_ = os.path.join(args.output_dir, f"{name}__cmp__0")
    frame_dir = None
    if args.export_frames:
        # frame layout <frame_path>/<scene>/{depth,color,camera}/ consumed by
        # the 2D-loss loader (reference data_util.py:862-902); the scene dir
        # uses the same name rule as the loader (strip any _room<k> part)
        frame_dir = os.path.join(
            args.frame_path or args.output_dir, name.split("_room")[0]
        )
    dims, _ = scan.virtual_scan(
        verts, faces, colors, traj, inc, cmp_, fusion_cfg=cfg, scan_cfg=sc,
        seed=args.seed, frame_export_dir=frame_dir, device=args.device,
    )
    print(f"scanned {name}: dims {dims} -> {inc}.sdf / {cmp_}.sdf"
          + (f" + {len(traj)} frames in {frame_dir}" if frame_dir else ""))


def cmd_sens(args):
    from ..datagen import sens

    os.makedirs(os.path.dirname(os.path.abspath(args.output_prefix)) or ".", exist_ok=True)
    dims, _ = sens.fuse_sens(
        args.sens, args.output_prefix, voxelsize=args.voxelsize,
        frame_skip=args.frame_skip, max_frames=args.max_frames, device=args.device,
    )
    print(f"fused {args.sens}: dims {dims} -> {args.output_prefix}.sdf")


def cmd_chunk(args):
    from ..datagen import chunks

    files = chunks.cut_scene_to_chunks(
        args.inc, args.cmp, args.output_dir, args.name,
        chunk_dims=tuple(args.chunk_dims),
        stride=(args.stride, args.stride) if args.stride else None,
        min_surface_voxels=args.min_surface_voxels,
        frame_info_dir=args.frame_info_dir or None,
    )
    print(f"wrote {len(files)} chunk pairs to {args.output_dir}")


def cmd_semantics(args):
    from ..datagen import semantics

    if args.vsegs:
        # raw Matterport annotations: mesh + .vsegs.json + .semseg.json
        # (reference Aggregation.h/Segmentation.h ingestion path)
        from ..ops import mesh as mesh_ops

        if not (args.semseg and args.mesh and args.mapping):
            raise SystemExit("--vsegs needs --semseg, --mesh and --mapping")
        verts, _, faces = mesh_ops.load_ply(args.mesh)
        vlabels = semantics.vertex_labels_from_segmentation(
            args.vsegs, args.semseg, args.mapping, id_column=args.mapping_column
        )
        cats = semantics.face_labels_from_vertex_labels(faces, vlabels)
        pts, labels = semantics.sample_labeled_mesh(
            verts, faces, cats, samples_per_face=args.samples_per_face
        )
    else:
        if not args.region_ply:
            raise SystemExit("pass --region_ply, or --vsegs/--semseg/--mesh")
        verts, faces, cats = semantics.read_labeled_ply(args.region_ply)
        pts, raw = semantics.sample_labeled_mesh(
            verts, faces, cats, samples_per_face=args.samples_per_face
        )
        if args.mapping:
            labels = semantics.labels_from_category_mapping(raw, args.mapping, args.mapping_column)
        else:
            labels = raw
    def extend_one(sdf_file):
        if args.scene_semantics:
            out = os.path.splitext(sdf_file)[0] + ".semantics"
            semantics.write_scene_semantics(sdf_file, out, pts, labels)
        else:
            out = sdf_file.replace("__cmp__", "__sem__")
            semantics.extend_sdf_file(sdf_file, out, pts, labels)

    files = sorted(glob.glob(args.sdf_glob))
    if args.workers > 1:
        # host-parallel splatting (reference extend_sdfs.py:270 uses a
        # 4-worker ThreadPoolExecutor; numpy splatting releases the GIL
        # enough for threads to help on multi-core hosts)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.workers) as ex:
            list(ex.map(extend_one, files))
    else:
        for sdf_file in files:
            extend_one(sdf_file)
    print(f"extended {len(files)} files")


def cmd_filelist(args):
    """Generate train/val file lists from a chunk directory (the reference
    ships plain-text lists in filelists/, data_util.py:20-38)."""
    import random as _random

    names = sorted(
        f for f in os.listdir(args.chunk_dir) if "__inc__" in f and f.endswith(".sdf")
    )
    _random.seed(args.seed)
    _random.shuffle(names)
    n_val = int(len(names) * args.val_fraction)
    val, train = names[:n_val], names[n_val:]
    with open(args.train_list, "w") as f:
        f.write("\n".join(train) + "\n")
    if args.val_list:
        with open(args.val_list, "w") as f:
            f.write("\n".join(val) + "\n")
    print(f"wrote {len(train)} train / {len(val)} val entries")


def cmd_category(args):
    from ..data import category

    category.save_category_npz(os.path.join(args.output_dir, "category.npz"))
    category.save_legend_png(os.path.join(args.output_dir, "Category_list.png"))
    print(f"wrote category.npz + Category_list.png to {args.output_dir}")


def _device_flag(parser):
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the TSDF grid lives and fuses (cuda: hand kernel K8)")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("scan")
    ps.add_argument("--mesh", required=True, help="room mesh .ply (binary)")
    ps.add_argument("--output_dir", required=True)
    ps.add_argument("--voxelsize", type=float, default=0.02)
    ps.add_argument("--num_frames", type=int, default=48)
    ps.add_argument("--chance_drop_frames", type=float, default=0.8)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--export_frames", action="store_true",
                    help="write depth/color/camera frame files + trajectory "
                    "sidecar for 2D-loss training")
    ps.add_argument("--frame_path", default="",
                    help="frame export root (default: output_dir)")
    _device_flag(ps)
    ps.set_defaults(fn=cmd_scan)

    pn = sub.add_parser("sens")
    pn.add_argument("--sens", required=True)
    pn.add_argument("--output_prefix", required=True)
    pn.add_argument("--voxelsize", type=float, default=0.02)
    pn.add_argument("--frame_skip", type=int, default=1)
    pn.add_argument("--max_frames", type=int, default=0)
    _device_flag(pn)
    pn.set_defaults(fn=cmd_sens)

    pc = sub.add_parser("chunk")
    pc.add_argument("--inc", required=True, help="incomplete scene prefix (no extension)")
    pc.add_argument("--cmp", required=True, help="complete scene prefix")
    pc.add_argument("--output_dir", required=True)
    pc.add_argument("--name", required=True)
    pc.add_argument("--chunk_dims", type=int, nargs=3, default=[128, 64, 64])
    pc.add_argument("--stride", type=int, default=0)
    pc.add_argument("--min_surface_voxels", type=int, default=500)
    pc.add_argument("--frame_info_dir", default="",
                    help="where to write per-chunk frame-association txt "
                    "(default: output_dir; requires a <cmp>.traj.npz sidecar)")
    pc.set_defaults(fn=cmd_chunk)

    pm = sub.add_parser("semantics")
    pm.add_argument("--region_ply", default="", help="labeled region segmentation ply")
    pm.add_argument("--vsegs", default="", help="raw Matterport .vsegs.json (with --semseg/--mesh)")
    pm.add_argument("--semseg", default="", help="raw Matterport .semseg.json")
    pm.add_argument("--mesh", default="", help="mesh .ply matching --vsegs vertex order")
    pm.add_argument("--sdf_glob", required=True, help="glob of __cmp__ .sdf files to extend")
    pm.add_argument("--mapping", default="", help="category_mapping.tsv (raw ids -> eigen13)")
    pm.add_argument("--mapping_column", default="eigen13id")
    pm.add_argument("--samples_per_face", type=int, default=4)
    pm.add_argument("--workers", type=int, default=4,
                    help="parallel splatting workers (reference "
                    "extend_sdfs.py:270 uses 4)")
    pm.add_argument("--scene_semantics", action="store_true",
                    help="write standalone .semantics (2cm scenes) instead of __sem__ chunks")
    pm.set_defaults(fn=cmd_semantics)

    pf = sub.add_parser("filelist")
    pf.add_argument("--chunk_dir", required=True)
    pf.add_argument("--train_list", required=True)
    pf.add_argument("--val_list", default="")
    pf.add_argument("--val_fraction", type=float, default=0.05)
    pf.add_argument("--seed", type=int, default=42)
    pf.set_defaults(fn=cmd_filelist)

    pg = sub.add_parser("category")
    pg.add_argument("--output_dir", default=".")
    pg.set_defaults(fn=cmd_category)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

"""The port's datagen CLI (python -m spsg_tpu_torch.cli.datagen) on the CPU:
the recipe of tests/test_cli.py::test_datagen_cli_end_to_end (scan, chunk,
semantics, filelist, category) against the JAX CLI in the same process, the
same file names and contents (tests/test_torch_datagen.py::assert_same_files);
scan and sens refusing to run on a GPU that is not there; and the loop of
tests/test_cli.py::test_datagen_frames_to_2d_training: scan with frame
export, chunk with frame association, the port's train CLI with the 2D losses
reading those frames."""

import csv
import os

import numpy as np
import pytest
import torch

from spsg_tpu.cli import datagen as jdg
from spsg_tpu_torch.cli import datagen as dg
from spsg_tpu_torch.cli import train as train_cli
from spsg_tpu_torch.datagen import scan
from spsg_tpu_torch.ops import mesh as mesh_ops

import test_torch_datagen as TD


def _floor_mesh(tmp_path):
    verts = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    mesh_path = str(tmp_path / "room.ply")
    mesh_ops.save_ply(mesh_path, verts, faces, np.full((4, 3), 120, np.uint8))
    region_path = str(tmp_path / "room_semseg.ply")
    TD.write_labeled_ply(region_path, verts, faces, [5, 5])
    return verts, mesh_path, region_path


def _cli_scan_views(verts, num_frames):
    """The scan CLI's orbit (cmd_scan) and intrinsics."""
    center, extent = verts.mean(0), verts.max(0) - verts.min(0)
    traj = scan.orbit_trajectory(center, radius=float(np.linalg.norm(extent[:2]) * 0.75),
                                 height=float(extent[2] * 1.2 + 0.5), num_frames=num_frames)
    sc = scan.ScanConfig()
    return traj, [sc.fx, sc.fy, sc.width / 2, sc.height / 2]


def test_datagen_cli_matches_the_jax_cli(tmp_path):
    """mesh -> scan -> chunk -> semantics -> filelist -> category, through
    both CLIs: the same files with the same contents."""
    verts, mesh_path, region_path = _floor_mesh(tmp_path)
    for pkg, cli, extra in (("port", dg, ["--device", "cpu"]), ("jax", jdg, [])):
        root = tmp_path / pkg
        scans, chunks_dir = str(root / "scans"), str(root / "chunks")
        cli.main(["scan", "--mesh", mesh_path, "--output_dir", scans, "--voxelsize", "0.08",
                  "--num_frames", "6"] + extra)
        assert os.path.isfile(os.path.join(scans, "room__cmp__0.sdf"))
        cli.main(["chunk", "--inc", os.path.join(scans, "room__inc__0"),
                  "--cmp", os.path.join(scans, "room__cmp__0"), "--output_dir", chunks_dir,
                  "--name", "room", "--chunk_dims", "16", "16", "16",
                  "--min_surface_voxels", "20"])
        cli.main(["semantics", "--region_ply", region_path,
                  "--sdf_glob", os.path.join(chunks_dir, "*__cmp__*.sdf"),
                  "--samples_per_face", "200"])
        cli.main(["filelist", "--chunk_dir", chunks_dir, "--train_list",
                  str(root / "train.txt"), "--val_list", str(root / "val.txt"),
                  "--val_fraction", "0.3"])
        cli.main(["category", "--output_dir", str(root)])
    port = tmp_path / "port" / "chunks"
    cmp_chunks = [f for f in os.listdir(port) if "__cmp__" in f]
    sem_chunks = [f for f in os.listdir(port) if "__sem__" in f]
    assert cmp_chunks and len(sem_chunks) == len(cmp_chunks)
    assert (tmp_path / "port" / "train.txt").read_text().strip()
    assert os.path.isfile(tmp_path / "port" / "Category_list.png")
    TD.assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"),
                         _cli_scan_views(verts, 6))


@pytest.mark.parametrize("sub", ["scan", "sens"])
def test_fusing_subcommands_run_on_the_gpu_unless_asked_otherwise(tmp_path, sub):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    _, mesh_path, _ = _floor_mesh(tmp_path)
    if sub == "scan":
        argv = ["scan", "--mesh", mesh_path, "--output_dir", str(tmp_path / "s"),
                "--voxelsize", "0.08", "--num_frames", "2"]
    else:
        from spsg_tpu_torch.datagen import sens
        d = np.full((1, 8, 8), 1.0, np.float32)
        sens.write_sens(str(tmp_path / "a.sens"), d, None, np.eye(4, dtype=np.float32)[None],
                        np.eye(4, dtype=np.float32))
        argv = ["sens", "--sens", str(tmp_path / "a.sens"), "--output_prefix",
                str(tmp_path / "s" / "fused"), "--voxelsize", "0.5"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        dg.main(argv)
    with pytest.raises(SystemExit):  # only cuda and cpu are devices of the CLI
        dg.main(argv + ["--device", "mps"])


def test_datagen_frames_to_2d_training(tmp_path):
    """scan --export_frames -> chunk with frame association -> the port's
    train CLI on the CPU with the 2D losses reading the exported frames."""
    verts = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0],
                      [-1, -1, 1], [1, -1, 1], [-1, 1, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [0, 1, 5], [0, 5, 4], [0, 3, 6], [0, 6, 4]],
                     np.int64)
    colors = np.stack([np.full(7, 200), np.full(7, 90), np.full(7, 40)], 1).astype(np.uint8)
    mesh_path = str(tmp_path / "boxroom.ply")
    mesh_ops.save_ply(mesh_path, verts, faces, colors)
    scans, frames = str(tmp_path / "scans"), str(tmp_path / "frames")
    dg.main(["scan", "--mesh", mesh_path, "--output_dir", scans, "--voxelsize", "0.08",
             "--num_frames", "8", "--chance_drop_frames", "0.5", "--export_frames",
             "--frame_path", frames, "--device", "cpu"])
    scene_dir = os.path.join(frames, "boxroom")
    for sub, name in (("depth", "0.png"), ("color", "0.jpg"), ("camera", "0.txt")):
        assert os.path.isfile(os.path.join(scene_dir, sub, name))
    assert os.path.isfile(os.path.join(scans, "boxroom__cmp__0.traj.npz"))

    chunks_dir = str(tmp_path / "chunks")
    dg.main(["chunk", "--inc", os.path.join(scans, "boxroom__inc__0"),
             "--cmp", os.path.join(scans, "boxroom__cmp__0"), "--output_dir", chunks_dir,
             "--name", "boxroom", "--chunk_dims", "16", "16", "16", "--min_surface_voxels", "20"])
    assoc = [f for f in os.listdir(chunks_dir) if f.endswith(".txt") and "__cmp__" in f]
    assert assoc
    ids = [int(x) for x in open(os.path.join(chunks_dir, assoc[0])).read().splitlines()]
    assert ids and all(0 <= i < 8 for i in ids)
    inc_chunks = sorted(f for f in os.listdir(chunks_dir) if "__inc__" in f)
    flist = str(tmp_path / "train.txt")
    with open(flist, "w") as f:
        f.write("\n".join(inc_chunks) + "\n")

    save = str(tmp_path / "run")
    train_cli.main([
        "--device", "cpu", "--data_path", chunks_dir, "--train_file_list", flist,
        "--val_file_list", flist, "--save", save, "--input_dim", "16", "--nf_gen", "4",
        "--nf_disc", "4", "--patch_size", "16", "--batch_size", "2", "--max_epoch", "1",
        "--num_iters_geo_only", "0", "--weight_depth_loss", "1", "--weight_disc_loss", "0.5",
        "--weight_semantic_loss", "0", "--frame_info_path", chunks_dir, "--frame_path", frames,
        "--style_width", "48", "--style_height", "32", "--max_depth_fill_iters", "4",
        "--lr", "1e-3", "--no_vis",
    ])
    rows = list(csv.DictReader(open(os.path.join(save, "log_val.csv"))))
    assert "train_loss(depth)" in rows[0]
    assert float(rows[-1]["train_loss(depth)"]) != -1.0
    assert float(rows[-1]["train_loss(disc)"]) != -1.0
    assert all(np.isfinite(float(v)) for k, v in rows[-1].items() if k.startswith("train_loss"))

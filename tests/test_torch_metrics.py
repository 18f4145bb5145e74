"""The port's metrics (spsg_tpu_torch/inference/metrics.py) and its metrics
and plot CLIs against the JAX package's on the CPU: tests/test_metrics.py's
six tests, ported, each also holding the port's value against the JAX
function's on the same inputs (the numpy / scipy copies within 1e-9,
Feature-l1 and FID through Inception-v3 within 1e-4 relative); the metrics
CLI over all five metrics with --device cpu against the JAX CLI's output files
on the same directories; its refusal to run on a CPU it was not asked to use; the plot
CLI on the logs of a port training run."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from spsg_tpu.cli import metrics as jax_mcli
from spsg_tpu.cli import plot as jax_plot
from spsg_tpu.inference import metrics as JM
from spsg_tpu_torch.cli import metrics as mcli
from spsg_tpu_torch.cli import plot
from spsg_tpu_torch.cli import train as train_cli
from spsg_tpu_torch.inference import metrics as M
from spsg_tpu_torch.ops import mesh

import torch_port_helpers  # noqa: F401  (one torch thread a worker)


@pytest.fixture(autouse=True)
def one_blas_thread():
    """One BLAS thread: FID's 2048x2048 sqrtm would otherwise take every core
    from the suite's other workers, whose multi-device JAX tests abort when
    their collectives are starved. threadpoolctl is optional: without it
    the tests run with NumPy's own thread count."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield


def test_ssim_identity_and_noise(rng):
    img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    assert M.ssim(img, img) == pytest.approx(1.0, abs=1e-6)
    noisy = np.clip(img.astype(float) + rng.normal(0, 40, img.shape), 0, 255)
    s = M.ssim(img, noisy)
    assert 0.0 < s < 0.9
    assert s == pytest.approx(JM.ssim(img, noisy), rel=0, abs=1e-9)


def test_chamfer_zero_and_offset(rng):
    pts = rng.random((500, 3)).astype(np.float32)
    assert M.chamfer_distance(pts, pts) == pytest.approx(0.0, abs=1e-10)
    shifted = pts + np.array([0.5, 0.0, 0.0], np.float32)
    d = M.chamfer_distance(pts, shifted)
    assert d > 0.01  # both directions accumulate squared distances
    assert d == pytest.approx(JM.chamfer_distance(pts, shifted), rel=0, abs=1e-9)
    one_way = M.chamfer_distance(pts, shifted[:300], bidirectional=False)
    assert one_way == pytest.approx(JM.chamfer_distance(pts, shifted[:300], False), abs=1e-9)


def test_feature_l1(rng):
    a = rng.random((64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.3, 0, 1)
    assert M.feature_l1(a, a, device="cpu") == pytest.approx(0.0, abs=1e-6)
    got = M.feature_l1(a, b, device="cpu")
    assert got > 0.0
    assert got == pytest.approx(JM.feature_l1(a, b), rel=1e-4)


def test_fid():
    """FID: zero for identical distributions, positive and larger for a
    shifted one (the reference delegates FID to the TTUR repo, metrics.py:7)."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, (64, 16))
    b = rng.normal(0, 1, (64, 16))
    c = rng.normal(2.0, 1, (64, 16))
    same = M.fid(a, a)
    close = M.fid(a, b)
    far = M.fid(a, c)
    assert abs(same) < 1e-6
    assert far > close > 0
    for x, y in ((a, a), (a, b), (a, c)):
        assert M.fid(x, y) == pytest.approx(JM.fid(x, y), rel=0, abs=1e-9)


def _write_images(d, shift, rng, names=("s0", "s1", "s2"), suffix="_x.png", size=32):
    os.makedirs(d, exist_ok=True)
    for n in names:
        img = (rng.random((size, size, 3)) * 120 + shift).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"{n}{suffix}"))


def test_fid_cli(tmp_path):
    rng = np.random.default_rng(1)
    for d, shift in (("p", 0), ("t", 80)):
        _write_images(tmp_path / d, shift, rng)
    out = tmp_path / "fid.txt"
    args = ["--metric", "fid", "--pred_dir", str(tmp_path / "p"),
            "--target_dir", str(tmp_path / "t"),
            "--pred_suffix", "_x.png", "--target_suffix", "_x.png"]
    summary = mcli.main(args + ["--output", str(out), "--device", "cpu"])
    val = float(open(out).read().split()[1])
    assert np.isfinite(val) and val > 0 and summary["fid"] == val
    # the JAX CLI on the same directories (Inception-v3's features agree within
    # 2e-6 of their largest entry; the distance within 1e-4 relative)
    jax_mcli.main(args + ["--output", str(tmp_path / "jax.txt")])
    assert val == pytest.approx(float(open(tmp_path / "jax.txt").read().split()[1]), rel=1e-4)
    # the same set through the port's and the JAX package's Inception-v3
    images = [np.array(Image.open(tmp_path / "p" / f)) / 255.0
              for f in sorted(os.listdir(tmp_path / "p"))]
    got, ref = M.image_features(images, device="cpu"), JM.image_features(images)
    assert got.shape == ref.shape == (3, 2048)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def _quad(x0, x1, z=0.5):
    v = np.array([[x0, 0.0, z], [x1, 0.0, z], [x1, 1.0, z], [x0, 1.0, z]], np.float32)
    return v, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


def test_mesh_voxelize_iou_recall():
    """voxelize_mesh / mesh_iou_recall (the reference's metrics.py:64 TODO,
    completed): identical meshes give IoU == Recall == 1; disjoint meshes
    give 0; a half-overlapping mesh lands in between; the JAX package's
    values on each pair."""
    v, f = _quad(0.0, 1.0)
    occ, origin = M.voxelize_mesh(v, f, 0.05)
    # a 1 m^2 plane at 5 cm voxels crosses ~20x20 voxels (plus edge overlap)
    assert 380 <= occ.sum() <= 1000
    jocc, jorigin = JM.voxelize_mesh(v, f, 0.05)
    assert np.array_equal(occ, jocc) and np.array_equal(origin, jorigin)
    iou, recall = M.mesh_iou_recall(v, f, v, f, 0.05)
    assert iou == pytest.approx(1.0) and recall == pytest.approx(1.0)

    v2, f2 = _quad(2.0, 3.0)  # disjoint
    iou, recall = M.mesh_iou_recall(v, f, v2, f2, 0.05)
    assert iou == 0.0 and recall == 0.0

    v3, f3 = _quad(0.5, 1.5)  # half overlap
    iou, recall = M.mesh_iou_recall(v, f, v3, f3, 0.05)
    assert 0.2 < iou < 0.5 and 0.4 < recall < 0.65
    jiou, jrecall = JM.mesh_iou_recall(v, f, v3, f3, 0.05)
    assert abs(iou - jiou) <= 1e-9 and abs(recall - jrecall) <= 1e-9


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    """Two scenes' meshes (a quad, and the prediction a narrower quad 2 cm
    above it) and their rendered and target images, named as the test CLIs
    write them."""
    d = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(4)
    for i, name in enumerate(("scene_a", "scene_b")):
        v, f = _quad(0.0, 1.0 + 0.5 * i)
        mesh.save_ply(str(d / f"{name}_target-mesh.ply"), v, f)
        vp, fp = _quad(0.1, 0.9 + 0.5 * i, z=0.52)
        mesh.save_ply(str(d / f"{name}_pred-mesh.ply"), vp, fp)
    _write_images(d, 0, rng, ("scene_a", "scene_b"), "_target.png", 40)
    _write_images(d, 30, rng, ("scene_a", "scene_b"), "_pred.png", 40)
    return d


METRIC_ARGS = {
    "chamfer": ["--num_samples", "3000"],
    "iou": ["--voxel_size", "0.05"],
    "ssim": ["--pred_suffix", "_pred.png", "--target_suffix", "_target.png"],
    "feature_l1": ["--pred_suffix", "_pred.png", "--target_suffix", "_target.png"],
}


def _read(path):
    rows = [line.split() for line in open(path).read().splitlines()]
    return {name: float(v) for name, v in rows}


@pytest.mark.parametrize("metric", list(METRIC_ARGS))
def test_metrics_cli_matches_the_jax_cli(metric, eval_dir, tmp_path):
    """Each per-pair metric over the same directory through both CLIs (FID,
    the fifth, in test_fid_cli): the same rows; the host metrics' values
    within 1e-9, Feature-l1 (Inception-v3's logits) within 1e-4 relative."""
    argv = ["--metric", metric, "--pred_dir", str(eval_dir), "--target_dir", str(eval_dir)]
    argv += METRIC_ARGS[metric]
    ours, theirs = tmp_path / "port.txt", tmp_path / "jax.txt"
    summary = mcli.main(argv + ["--output", str(ours), "--device", "cpu"])
    jax_mcli.main(argv + ["--output", str(theirs)])
    got, ref = _read(ours), _read(theirs)
    assert got.keys() == ref.keys() and len(got) == 3
    tol = 1e-4 if metric == "feature_l1" else None
    for k, v in ref.items():
        assert np.isfinite(got[k]), k
        if tol is None:
            assert abs(got[k] - v) <= 1e-9, (k, got[k], v)
        else:
            assert got[k] == pytest.approx(v, rel=tol), (k, got[k], v)
    assert summary["mean"] == got["mean"]


def test_metrics_cli_runs_on_the_gpu_unless_asked_otherwise(eval_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.txt"
    with pytest.raises(RuntimeError, match="--device cpu"):
        mcli.main(["--metric", "feature_l1", "--pred_dir", str(eval_dir), "--target_dir",
                   str(eval_dir), "--output", str(out)] + METRIC_ARGS["feature_l1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.feature_l1(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)))
    assert not out.exists()


def test_plot_cli_draws_a_port_training_run(tmp_path):
    """The plot CLI on the logs of the port's train CLI (20 iterations: one
    row of log.csv, one of log_val.csv): loss.png, the same image as the JAX
    package's plot CLI draws from the same directory."""
    save = str(tmp_path / "run")
    train_cli.main(["--device", "cpu", "--synthetic_chunks", "40", "--input_dim", "16",
                    "--nf_gen", "4", "--num_iters_geo_only", "1", "--weight_disc_loss", "0",
                    "--weight_depth_loss", "0", "--max_epoch", "1", "--no_vis", "--save", save])
    assert len(open(os.path.join(save, "log.csv")).read().splitlines()) == 2
    out = plot.main(["--run_dir", save, "--name", "port run"])
    assert out == os.path.join(save, "loss.png")
    jax_plot.main(["--run_dir", save, "--name", "port run", "--output",
                   str(tmp_path / "jax.png")])
    got, ref = np.array(Image.open(out)), np.array(Image.open(tmp_path / "jax.png"))
    assert got.shape == ref.shape and got.shape[0] > 100 and np.array_equal(got, ref)

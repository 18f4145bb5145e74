"""The port's CLIs as two processes of a gloo group on the CPU, launched the way
parallel/multihost.py documents (SPSG_COORDINATOR / SPSG_NUM_PROCESSES /
SPSG_PROCESS_ID, every rank with the same flags; tests/torch_parallel_worker.py
calls each CLI's main): the train CLI with --distributed (the counterpart of
tests/test_multihost.py, fast enough for Tier-1) and the whole-scene CLI with
--spatial_shard."""

import os

import numpy as np

from spsg_tpu_torch.cli import test_scene

import torch_parallel_worker as W

TRAIN = ["--distributed", "--device", "cpu", "--synthetic_chunks", "4", "--input_dim", "16",
         "--nf_gen", "4", "--batch_size", "2", "--weight_disc_loss", "0",
         "--weight_depth_loss", "0", "--num_iters_geo_only", "1", "--lr", "1e-3"]
SCENE = ["--device", "cpu", "--synthetic_scenes", "1", "--nf_gen", "4", "--max_input_height",
         "16", "--style_width", "48", "--style_height", "32", "--num_to_vis", "1"]


def _train(tmp_path, name, argv):
    """The train CLI on two ranks, each saving to <name><rank>; returns both
    ranks' final generator state and their logs."""
    d = tmp_path / name
    W.save_inputs(d, argv=argv, save=str(tmp_path / (name + "{rank}")))
    ranks = W.run_ranks("train_cli", d)
    logs = [open(d / f"train_cli_rank{r}.log").read() for r in range(2)]
    return ranks, logs


def test_train_cli_distributed_on_two_processes(tmp_path):
    """Both ranks print `distributed: process i/2`, train two epochs of the
    two global batches of 2 (one chunk a rank), and end with the same
    parameters and BatchNorm statistics; only rank 0 writes args.txt, the
    logs, the visual dumps and the checkpoints. The second epoch resumed on
    two ranks from rank 0's model-epoch0.pt (every rank loads the file) ends
    as the unbroken run does, by ROADMAP.md Queue C's Adam rule: every
    parameter within 2 * lr per step taken and >= 99.9 % within 1e-5 (here on
    the CPU, measured: equal to the bit)."""
    (r0, r1), logs = _train(tmp_path, "run", TRAIN + ["--max_epoch", "2"])
    for r in range(2):
        assert f"distributed: process {r}/2, device cpu, backend gloo" in logs[r]
    assert r0.keys() == r1.keys() and len(r0) > 100
    for k in r0:
        assert np.array_equal(r0[k], r1[k]), k
    assert {"args.txt", "log.csv", "log_val.csv", "model-epoch0.pt", "model-epoch1.pt"} <= set(
        os.listdir(tmp_path / "run0"))
    assert os.listdir(tmp_path / "run1") == []
    with open(tmp_path / "run0" / "log_val.csv") as f:
        assert len(f.read().strip().splitlines()) == 3  # the header and two epochs

    ckpt = str(tmp_path / "run0" / "model-epoch0.pt")
    (q0, q1), logs = _train(tmp_path, "resumed", TRAIN + ["--max_epoch", "2", "--retrain", ckpt])
    assert all(f"loaded checkpoint {ckpt} (epoch 1)" in log for log in logs)
    lr, diffs = 1e-3, []
    for k in r0:
        assert np.array_equal(q0[k], q1[k]), k
        d = np.abs(q0[k].astype(np.float64) - r0[k])
        assert d.max() <= 2 * lr * 2, k  # two steps taken since the checkpoint
        diffs.append(d.ravel())
    assert (np.concatenate(diffs) <= 1e-5).mean() >= 0.999


def test_scene_cli_spatial_shard_on_two_processes(tmp_path):
    """The synthetic scene cut to 16 x 160 x 192, split along Y into slabs of
    80 rows: rank 0
    writes the meshes and the renders, byte for byte the files of the
    one-process CLI on the same scene; rank 1 writes nothing."""
    W.save_inputs(tmp_path, argv=SCENE + ["--spatial_shard"], output=str(tmp_path / "s{rank}"))
    W.run_ranks("scene_cli", tmp_path)
    assert "spatial shard: process 1/2" in open(tmp_path / "scene_cli_rank1.log").read()
    test_scene.main(SCENE + ["--output", str(tmp_path / "one")])
    names = sorted(os.listdir(tmp_path / "one"))
    assert len(names) >= 10 and sorted(os.listdir(tmp_path / "s0")) == names
    assert not os.path.exists(tmp_path / "s1") or os.listdir(tmp_path / "s1") == []
    for n in names:
        with open(tmp_path / "one" / n, "rb") as a, open(tmp_path / "s0" / n, "rb") as b:
            assert a.read() == b.read(), n

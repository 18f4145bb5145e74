"""The JAX package's trained models in the port, on the CPU: the committed
nf-20 export (docs/evidence/torch_port/epoch59, tools/export_torch_goldens.py)
against a fresh export of its orbax checkpoint; the port against the JAX
package with those weights at nf 20; the golden files of the nf-4 checkpoint
held by chip_smoke.py's own comparisons (its phase "trained" holds the card to
the nf-20 files with them), which a seeded fault fails; and the gradient rule
of chip_smoke.py at 16^3 / nf 4."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu_torch.data import pipeline, synthetic
from spsg_tpu_torch.inference import chunked
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training import state
from spsg_tpu_torch.training.step import Trainer
from spsg_tpu_torch.utils import goldens as golden_files

import torch_port_helpers as H

sys.path.insert(0, H.REPO)
sys.path.insert(0, os.path.join(H.REPO, "tools"))
import chip_smoke as cs  # noqa: E402
import export_torch_goldens  # noqa: E402

EPOCH59 = os.path.join(H.REPO, "docs", "evidence", "bench_r4", "curriculum_run", "model-epoch59")
# the orbax template's shapes do not depend on the chunk or image size: a small
# one restores the same variables without a full-size init
SMALL = dict(input_dim=(16, 16, 16), style_width=48, style_height=32)


@pytest.fixture(scope="module")
def epoch59(tmp_path_factory):
    """A fresh export_torch_checkpoint.export of the orbax model-epoch59 and
    the JAX states its one restore returned: (.pt, gen_state, epoch)."""
    raw = export_torch_goldens.run_args(os.path.join(os.path.dirname(EPOCH59), "args.txt"))
    cfg = dataclasses.replace(export_torch_goldens.run_config(raw), **SMALL)
    fresh = str(tmp_path_factory.mktemp("epoch59") / "fresh.pt")
    gen_state, _, epoch = export_torch_goldens.export_and_restore(EPOCH59, fresh, cfg)
    return fresh, gen_state, epoch


# --- the committed .pt is a fresh export, and the manifest names it ---------

def test_committed_export_equals_a_fresh_export(epoch59):
    manifest = json.load(open(os.path.join(cs.TRAINED_DIR, "MANIFEST.json")))
    pt = os.path.join(cs.TRAINED_DIR, "model-epoch59.pt")
    assert manifest["checkpoint"] == os.path.relpath(EPOCH59, H.REPO)
    assert golden_files.sha256_file(pt) == manifest["files"]["model-epoch59.pt"]["sha256"]
    fresh, _, epoch = epoch59
    assert epoch == 60
    a, b = (torch.load(p, weights_only=True) for p in (pt, fresh))
    assert a.keys() == b.keys() == {"epoch", "state_dict", "disc_state_dict", "sn_state"}
    assert a["epoch"] == b["epoch"] == 60
    for key in ("state_dict", "disc_state_dict"):
        assert a[key].keys() == b[key].keys()
        assert all(torch.equal(v, b[key][k]) for k, v in a[key].items()), key
    assert a["sn_state"].keys() == b["sn_state"].keys()
    assert all(torch.equal(v, b["sn_state"][n][k])
               for n, d in a["sn_state"].items() for k, v in d.items())
    # and every file of the directory is the one the manifest names
    assert cs.load_goldens()[3] == pt


# --- the port with the .pt against the JAX package at nf 20 -----------------

def test_trained_nf20_generator_matches_jax(epoch59):
    """Eval forward of one seeded (32,32,32) chunk at the trained width:
    tests/test_torch_generator.py's rule (every output within 5e-4)."""
    _, gs, _ = epoch59
    x, m = H.chunk_inputs(batch=1, dims=(32, 32, 32), seed=5)
    gen = JaxGenerator(JaxGeneratorConfig(nf=20))
    ref = jax.jit(lambda v, x, m: gen.apply(v, x, m, pred_color=True, pred_sdf=True,
                                            pred_semantic=True, train=False))(
        {"params": gs.params, "batch_stats": gs.batch_stats}, jnp.asarray(x), jnp.asarray(m))
    port = state.make_generator(TrainConfig(input_dim=(32, 32, 32)), device="cpu")
    port, _ = state.load_checkpoint(os.path.join(cs.TRAINED_DIR, "model-epoch59.pt"), port)
    with torch.no_grad():
        got = port.eval()(H.t(x), H.t(m), pred_color=True, pred_semantic=True)
    for g, r, name in zip(got, ref, ("occ", "sdf", "color", "semantic")):
        r = np.asarray(r)
        assert g.shape == r.shape and np.abs(r).max() > 1e-2, name
        np.testing.assert_allclose(g.numpy(), r, atol=5e-4, err_msg=name)


# --- the nf-20 validation golden's views, on the CPU, at full size ----------

def _golden_chunk_batch(val, cfg, i):
    """Chunk i of golden_val.json's validation set as the golden took it
    (chip_smoke.py's golden_validation_set: the frame in the arithmetic of
    the port that wrote the golden), prepared for a step."""
    from spsg_tpu_torch.training.loop import _prepare_batch

    sample = cs.golden_validation_set(cfg, val, [i])[0]
    return _prepare_batch({k: v[None] for k, v in sample.items() if isinstance(v, np.ndarray)},
                          cfg, val["iteration"])


@pytest.mark.parametrize("chunk", [0, 7])
def test_port_views_on_the_cpu_are_the_nf20_goldens(chunk):
    """precompute_views at the run's full size ((128,64,64), 320x256) on
    synthetic_0 (8 / 4 hits patched in the golden) and synthetic_7 (209
    normal entries up to 0.074 apart): the marches hash to the golden's, and
    at every index of the chunk's march_patches the port's own view holds the
    JAX value, within the tolerance that chose those indices (the same
    numbers in tools/export_torch_goldens.py and utils/goldens.py)."""
    assert golden_files.PATCH_TOL == export_torch_goldens.PATCH_TOL
    _, val, _, _ = cs.load_goldens()
    cfg = cs.run_config(val["args"])
    assert tuple(cfg.input_dim) == (128, 64, 64)
    assert (cfg.style_width, cfg.style_height) == (320, 256)
    gc = val["chunks"][chunk]
    batch = _golden_chunk_batch(val, cfg, chunk)
    assert golden_files.frame_digest(batch) == gc["frame_sha256"]
    views = {k: v.numpy() for k, v in Trainer(cfg, "cpu").precompute_views(batch).items()}
    hashes = {k: golden_files.array_digest(views[k]) for k in gc["march_sha256"]}
    assert hashes == gc["march_sha256"]
    assert sum(len(v[0]) for v in gc["march_patches"].values()) > 0
    assert golden_files.patches_not_held(views, gc["march_patches"]) == {
        k: 0 for k in gc["march_patches"]}


# --- nf-4 goldens held by chip_smoke.py's comparisons ----------------------

@pytest.fixture(scope="module")
def goldens(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("goldens"))
    export_torch_goldens.write_goldens(H.EPOCH39, out, stride=8)
    manifest, val, golden, pt = cs.load_goldens(out)
    cfg = cs.run_config(val["args"])
    return dict(val=val, golden=golden, pt=pt, cfg=cfg,
                samples=cs.golden_validation_set(cfg, val))


def _scene(g):
    """golden_chunked.npz's scene, assembled as the chunked CLI assembles its
    synthetic scene: (input, mask, target sdf, known, semantics)."""
    s = synthetic.make_scene(dims=tuple(int(d) for d in g["scene_dims"]),
                             seed=int(g["scene_seed"]))
    sample = pipeline.assemble_sample(s.sdf_input, s.sdf_complete, s.input_colors, s.colors,
                                      s.semantics, s.known, s.world2grid, float(g["truncation"]),
                                      "lab", None)
    return (sample["input"], sample["mask"], sample["target_sdf"], sample["known"],
            sample["semantics"])


def _chunked(goldens, gen, scene=None):
    g = goldens["golden"]
    scene = scene or _scene(g)
    return chunked.run_chunked_inference(
        gen, *scene, chunk_dims=tuple(int(d) for d in g["chunk_dims"]),
        stride=int(g["stride"]), window_batch=4, device="cpu")


def _generator(goldens, fault=False):
    gen = state.make_generator(goldens["cfg"], device="cpu")
    gen, _ = state.load_checkpoint(goldens["pt"], gen)
    if fault:  # one weight of one conv off by a tenth of the conv's largest weight
        with torch.no_grad():
            w = gen.geo_2b.weight
            w[1, 2, 1, 1, 1] += 0.1 * w.abs().max()
    return gen


def _validation(goldens, fault=False, samples=None):
    trainer = Trainer(goldens["cfg"], "cpu", seed=0)
    state.load_checkpoint(goldens["pt"], trainer)
    if fault:
        trainer.generator = _generator(goldens, fault=True)
    return cs.port_validation(trainer, goldens["val"], samples or goldens["samples"])


def test_port_on_the_cpu_matches_the_nf4_goldens(goldens):
    rec = cs.compare_chunked_golden(_chunked(goldens, _generator(goldens)), goldens["golden"],
                                    "nf-4 chunked scene")
    assert rec["sdf_voxels_compared"] > 1000 and rec["counts_agree"] >= 0.999
    chunks = _validation(goldens)
    assert all(c["frame_is_golden"] for c in chunks)
    val = cs.compare_val_golden(chunks, goldens["val"], "nf-4 validation")
    assert val["worst_rel_diff"] <= 1e-4


def test_a_weight_off_fails_the_goldens(goldens):
    with pytest.raises(SystemExit, match="against the JAX golden"):
        cs.compare_chunked_golden(_chunked(goldens, _generator(goldens, fault=True)),
                                  goldens["golden"], "nf-4 chunked scene, a weight off")
    with pytest.raises(SystemExit, match="against the JAX golden"):
        cs.compare_val_golden(_validation(goldens, fault=True), goldens["val"],
                              "nf-4 validation, a weight off")


def test_a_flipped_label_fails_the_goldens(goldens):
    """One voxel's target label flipped: the scene's class weights and IoUs,
    and the validation's semantic loss, move."""
    scene = list(_scene(goldens["golden"]))
    sem = scene[4].copy()
    z, y, x = np.argwhere((sem > 0) & (goldens["golden"]["counts"] > 0))[0]
    sem[z, y, x] = 1 + sem[z, y, x] % 13
    scene[4] = sem
    with pytest.raises(SystemExit, match="against the JAX golden"):
        cs.compare_chunked_golden(_chunked(goldens, _generator(goldens), scene),
                                  goldens["golden"], "nf-4 chunked scene, a label flipped")
    samples = [dict(s) for s in goldens["samples"]]
    sem = samples[0]["semantics"].copy()
    z, y, x = np.argwhere((sem > 0) & (np.abs(samples[0]["target_sdf"]) < 1))[0]
    sem[z, y, x] = 1 + sem[z, y, x] % 13
    samples[0]["semantics"] = sem
    with pytest.raises(SystemExit, match="against the JAX golden"):
        cs.compare_val_golden(_validation(goldens, samples=samples), goldens["val"],
                              "nf-4 validation, a label flipped")


# --- the gradient rule at 16^3 / nf 4 --------------------------------------

def test_gradient_rule_passes_the_steps_and_fails_the_faults():
    """chip_smoke.py's RULE_CASES on the full step from one state: the
    kernels' plain versions against the plain twin and the z-slab / folded
    steps against the default step pass against a float64 yardstick; a wrong
    weight tap in a z-slab conv and a wrong tap in K2's output fail."""
    cfg = TrainConfig(input_dim=(16, 16, 16), nf_gen=4, nf_disc=4, style_width=48,
                      style_height=32, patch_size=16, max_depth_fill_iters=8,
                      min_num_valid_2d=10)
    batch = synthetic.make_chunk_batch(2, (16, 16, 16), (48, 32), seed=1, with_frames=True,
                                       device="cpu")
    batch.pop("name")
    batch["weight_occ"] = np.float32(1.0)
    base = Trainer(cfg, "cpu", seed=3)
    cs.scale_conv_weights(base.generator, 2.0)
    grads, metrics, _ = cs.witness_steps(base, batch, StepFlags(**cs.FULL_2D))
    rules = cs.rule_cases(grads, "16^3 step")
    assert all(r["as_expected"] for r in rules.values()), rules
    assert [c for c, r in rules.items() if r["passed"]] == ["default", "zslab_conv",
                                                            "folded_conv"]
    # each fault is one the 1e-2 rule fails too
    assert not any(rules[c]["old_rule_passed"] for c in ("fault_zslab_tap", "fault_k2_tap"))
    assert all(np.isfinite(v) for m in metrics.values() for v in m.values())

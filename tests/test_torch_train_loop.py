"""The port's training loop (spsg_tpu_torch/training/loop.py), its cached view
precomputation (Trainer.precompute_views, RenderCache) and its whole-state
checkpoints, on the CPU at 16^3 / nf 4 / 48x32:

(a) run_training against the JAX package's, 2 epochs of 3D losses from the
    same initial weights: log_val.csv's header identical, epoch and iter
    equal, the losses within 1e-4 relative, the same checkpoint names;
(b) precompute_views against the JAX package's with weight_missing_color 2:
    hits identical (Queue C's march tolerance at this size), depth within
    1e-5 voxels, normals within 2e-5, frames_ok and the occupancy masks
    identical;
(c) a step fed the precomputation (a dict, or per-sample slices) against one
    without it: the same metrics, parameters and optimizer states to the bit;
(d) RenderCache: LRU, per-sample hits, a half-missing batch recomputing only
    its missing sample with entries equal to the bit to the full batch's, also
    on a batch whose frames mix holes and none;
(e) run_training with cache_renders 8 against 0: the same final state to the bit;
(f) one epoch, then a resume from its checkpoint, against two epochs: the same
    parameters, buffers, both Adams, spectral state and iteration count to the bit;
(g) a stop request writes model-preempt-iter*.pt and restores the handlers."""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.cli.train import SyntheticChunkDataset as JaxChunks
from spsg_tpu.data import synthetic as jax_synthetic
from spsg_tpu.training import TrainConfig as JaxTrainConfig
from spsg_tpu.training import loop as jax_loop
from spsg_tpu.training.state import init_states
from spsg_tpu.training.step import Trainer as JaxTrainer
from spsg_tpu_torch.cli.train import SyntheticChunkDataset
from spsg_tpu_torch.models.convert import flax_to_torch_generator
from spsg_tpu_torch.ops import raycast as raycast_ops
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training import loop, state
from spsg_tpu_torch.training.step import Trainer

import torch_port_helpers as H

DIMS = (16, 16, 16)
# tests/test_train_step.py::_tiny_cfg
TINY = dict(input_dim=DIMS, nf_gen=4, nf_disc=4, batch_size=2, style_width=48, style_height=32,
            patch_size=16, num_iters_geo_only=2, max_depth_fill_iters=8, min_num_valid_2d=10)
FULL = dict(pred_sdf=True, pred_color=True, pred_semantic=True, use_2d=True, use_disc=True)
# an 8^3 block of the input emptied: the target's surface there is missing
# from the input, which weight_missing_color > 1 weights (~10 % of the pixels)
PUNCH = (slice(None), slice(0, 8), slice(8, 16), slice(8, 16), 0)


def _batch(punch=True, mixed_holes=False):
    batch = jax_synthetic.make_chunk_batch(2, DIMS, image_dims=(48, 32), seed=1,
                                           with_frames=True)
    batch.pop("name")
    batch["weight_occ"] = np.float32(1.0)
    if punch:
        batch["input"] = batch["input"].copy()
        batch["input"][PUNCH] = 3.0
    if mixed_holes:
        # frame 1 without holes, frame 0 with them
        d = batch["images_depth"].copy()
        d[1] = np.where(d[1] == 0.0, 1.0, d[1])
        batch["images_depth"] = d
    return batch


def _trainer(**kw):
    return Trainer(TrainConfig(**{**TINY, **kw}), device="cpu", seed=0)


def _state(trainer):
    """Everything a resumed run must get back, as flat tensors."""
    out = {f"gen.{k}": v for k, v in trainer.generator.state_dict().items()}
    for name, opt in (("adam", trainer.optimizer), ("disc_adam", trainer.disc_optimizer)):
        if opt is None:
            continue
        for i, s in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in s.items()})
    if trainer.discriminator is not None:
        out.update({f"disc.{k}": v for k, v in trainer.discriminator.state_dict().items()})
        out.update({f"sn.{k}.{kk}": vv for k, v in trainer.sn_state.items()
                    for kk, vv in v.items()})
    return out


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# --- (a) the loop against the JAX package's -----------------------------------

def test_training_run_matches_the_jax_loop(tmp_path):
    kw = dict(input_dim=DIMS, nf_gen=4, batch_size=2, num_iters_geo_only=1,
              weight_depth_loss=0.0, weight_disc_loss=0.0)
    jcfg, cfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jax_loop.run_training(jcfg, JaxChunks(4, jcfg, False, seed=1), JaxChunks(2, jcfg, False, seed=2),
                          save_dir=str(tmp_path / "jax"), max_epoch=2, vis_at_epoch_end=False)
    # the port starts from the same weights: the JAX package's init_states(cfg,
    # PRNGKey(0)), carried across the weight bridge
    gs, _ = init_states(jcfg, jax.random.PRNGKey(0))
    init = str(tmp_path / "init.pt")
    torch.save({"epoch": 0, "state_dict": flax_to_torch_generator(
        H.to_numpy_tree({"params": gs.params, "batch_stats": gs.batch_stats}))}, init)
    result = loop.run_training(
        cfg, SyntheticChunkDataset(4, cfg, False, seed=1, device="cpu"),
        SyntheticChunkDataset(2, cfg, False, seed=2, device="cpu"),
        save_dir=str(tmp_path / "port"), max_epoch=2, retrain=init, vis_at_epoch_end=False,
        device="cpu")
    assert result.iteration == 4 and result.trainer.iteration == 4

    rows = {}
    for name in ("jax", "port"):
        lines = (tmp_path / name / "log_val.csv").read_text().splitlines()
        rows[name] = [line.split(",") for line in lines]
    header = rows["jax"][0]
    assert rows["port"][0] == header and len(rows["port"]) == len(rows["jax"]) == 3
    for rj, rp in zip(rows["jax"][1:], rows["port"][1:]):
        assert rj[:2] == rp[:2]
        for name, a, b in zip(header[2:-1], rj[2:-1], rp[2:-1]):
            a, b = float(a), float(b)
            # measured: within 2.5e-6 relative; -1 (never reported) on both sides
            assert abs(a - b) <= 1e-4 * max(abs(a), 1e-6), (name, a, b)
    assert [r[:2] for r in rows["port"][1:]] == [["0", "2"], ["1", "4"]]
    jax_ckpts = sorted(f for f in os.listdir(tmp_path / "jax") if f.startswith("model-"))
    port_ckpts = sorted(f for f in os.listdir(tmp_path / "port") if f.startswith("model-"))
    assert jax_ckpts == ["model-epoch0", "model-epoch1"]
    assert port_ckpts == [f + ".pt" for f in jax_ckpts]


# --- (b) precompute_views against the JAX package's -----------------------------

def test_precompute_views_matches_the_jax_package():
    batch = _batch()
    jcfg = JaxTrainConfig(**TINY, weight_missing_color=2.0)
    want = {k: np.asarray(v) for k, v in JaxTrainer(jcfg).precompute_views(
        {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    got = {k: v.numpy() for k, v in _trainer(weight_missing_color=2.0).precompute_views(
        batch).items()}
    assert got.keys() == want.keys()
    for name in ("in", "tgt"):
        hit = want[f"{name}_hit"]
        np.testing.assert_array_equal(got[f"{name}_hit"], hit)
        np.testing.assert_array_equal(got[f"{name}_hit_idx"][hit], want[f"{name}_hit_idx"][hit])
        np.testing.assert_allclose(got[f"{name}_depth"][hit], want[f"{name}_depth"][hit],
                                   rtol=0, atol=1e-5)
        assert hit.sum() > 100
    np.testing.assert_allclose(got["images_normals"], want["images_normals"], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got["frames_ok"], want["frames_ok"])
    for k in ("missing2d", "tgt_mask2d"):
        assert got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], want[k])
    weighted = (got["missing2d"] != 0) & (got["tgt_mask2d"] != 0)
    assert 100 < weighted.sum() < weighted.size // 2


# --- (c) a step fed the precomputation -----------------------------------------

@pytest.mark.parametrize("form", ["dict", "per_sample"])
def test_precomputed_views_step_bit_identical(form):
    batch = _batch()
    ref = _trainer(weight_missing_color=2.0)
    m_ref = ref.step(batch, StepFlags(**FULL))
    trainer = _trainer(weight_missing_color=2.0)
    pre = trainer.precompute_views(batch)
    if form == "per_sample":
        pre = tuple({k: v[i:i + 1] for k, v in pre.items()} for i in range(2))
    raycast_ops.reset_launch_counts()
    metrics = trainer.step(batch, StepFlags(**FULL), precomp=pre)
    assert metrics.keys() == m_ref.keys()
    for k in metrics:
        assert torch.equal(metrics[k], m_ref[k]), k
    _assert_same_state(trainer, ref)
    assert not any(raycast_ops.launch_counts.values())  # the CPU has no kernels


def test_missing_colour_weights_reach_the_losses():
    """weight_missing_color 2 against 1 on the same batch: the colour L1 and
    the discriminator's losses move, the 3D ones do not."""
    m1 = _trainer().step(_batch(), StepFlags(**FULL))
    m2 = _trainer(weight_missing_color=2.0).step(_batch(), StepFlags(**FULL))
    for k in ("loss_occ", "loss_sdf", "loss_depth"):
        assert torch.equal(m1[k], m2[k]), k
    for k in ("loss_color", "loss_disc_real", "loss_disc_fake"):
        assert not torch.equal(m1[k], m2[k]), k


# --- (d) RenderCache ------------------------------------------------------------

@pytest.mark.parametrize("frames", ["rendered", "mixed_holes"])
def test_render_cache_lru(frames):
    trainer = _trainer(weight_missing_color=2.0)
    batch = trainer._to_device(_batch(mixed_holes=frames == "mixed_holes"))
    rc = loop.RenderCache(trainer, capacity=4)
    names = ["chunk_a", "chunk_b"]
    fids = [np.array([3]), np.array([7])]
    p1 = rc.lookup(batch, names, fids)
    assert rc.misses == 2 and rc.hits == 0 and len(p1) == 2
    p2 = rc.lookup(batch, names, fids)
    assert rc.hits == 2 and rc.misses == 2
    for a, b in zip(p1, p2):
        assert all(a[k] is b[k] for k in a)
    # the same chunk with other frames is another key: only that sample misses
    p3 = rc.lookup(batch, names, [np.array([4]), np.array([7])])
    assert rc.misses == 3 and rc.hits == 3
    assert all(p3[1][k] is p1[1][k] for k in p1[1])
    # a half-missing batch recomputes only sample 1, as a B=1 sub-batch; its
    # entries equal the same sample's from the B=2 precompute to the bit (the
    # depth chain runs per frame: with a batch-wide decision, frame 1 of the
    # mixed batch would be filtered in the B=2 batch only)
    rc_b = loop.RenderCache(trainer, capacity=8)
    rc_b.lookup(batch, ["other_a", "other_b"], fids)
    pb = rc_b.lookup(batch, ["other_a", "chunk_b2"], fids)
    assert rc_b.misses == 3
    for k in p1[1]:
        assert torch.equal(pb[1][k], p1[1][k]), k
    if frames == "mixed_holes":
        assert bool(p1[0]["frames_ok"].all()) and bool(p1[1]["frames_ok"].all())
    # capacity 1: each 2-sample batch overflows, evicting LRU-first
    rc1 = loop.RenderCache(trainer, capacity=1)
    rc1.lookup(batch, names, fids)
    rc1.lookup(batch, names, fids)
    assert len(rc1._d) == 1


# --- (e), (f), (g): run_training on the port ----------------------------------

LOOP = dict(TINY, num_iters_geo_only=0, max_depth_fill_iters=20)


@pytest.fixture(scope="module")
def chunks():
    cfg = TrainConfig(**LOOP)
    return (SyntheticChunkDataset(4, cfg, True, seed=1, device="cpu"),
            SyntheticChunkDataset(2, cfg, True, seed=2, device="cpu"))


def _run(tmp_path, name, chunks, max_epoch, **kw):
    cfg = TrainConfig(**{**LOOP, **kw.pop("cfg", {})})
    return loop.run_training(cfg, chunks[0], chunks[1], save_dir=str(tmp_path / name),
                             max_epoch=max_epoch, device="cpu", **kw)


def test_render_cache_training_bit_identical(tmp_path, chunks):
    plain = _run(tmp_path, "plain", chunks, 2)
    cached = _run(tmp_path, "cached", chunks, 2, cfg=dict(cache_renders=8))
    assert plain.render_cache is None and cached.render_cache.hits > 0
    # 3 full steps of 2 samples; epoch 0's second batch fills the cache
    assert cached.render_cache.hits + cached.render_cache.misses == 6
    _assert_same_state(cached.trainer, plain.trainer)
    logs = [(tmp_path / n / "log_val.csv").read_text().splitlines() for n in ("plain", "cached")]
    strip = [[line.rsplit(",", 1)[0] for line in lg] for lg in logs]  # without the time
    assert strip[0] == strip[1]
    assert {"setup", "cache", "step", "log"} == set().union(*cached.timer.history)


def test_resume_equals_an_unbroken_run(tmp_path, chunks):
    whole = _run(tmp_path, "whole", chunks, 2)
    _run(tmp_path, "first", chunks, 1)
    ckpt = str(tmp_path / "first" / "model-epoch0.pt")
    assert sorted(torch.load(ckpt, weights_only=True)) == [
        "disc_optimizer", "disc_state_dict", "epoch", "optimizer", "sn_state", "state_dict"]
    resumed = _run(tmp_path, "resumed", chunks, 2, retrain=ckpt)
    assert resumed.iteration == whole.iteration == 4
    _assert_same_state(resumed.trainer, whole.trainer)
    assert all(int(s["step"]) == 4 for s in resumed.trainer.optimizer.state.values())
    rows = (tmp_path / "resumed" / "log_val.csv").read_text().splitlines()
    assert len(rows) == 2 and rows[1].startswith("1,4,")
    # the serving side reads the generator of a training checkpoint
    gen = state.make_generator(TrainConfig(**LOOP), device="cpu")
    gen, epoch = state.load_checkpoint(str(tmp_path / "whole" / "model-epoch1.pt"), gen)
    assert epoch == 2
    sd = whole.trainer.generator.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in gen.state_dict().items())


def test_stop_request_writes_a_preemption_checkpoint(tmp_path, chunks, monkeypatch):
    before = signal.getsignal(signal.SIGTERM)
    real_step = Trainer.step
    requested = []

    def step(self, *a, **kw):
        out = real_step(self, *a, **kw)
        handler = signal.getsignal(signal.SIGTERM)
        assert callable(handler) and handler is not before
        handler(signal.SIGTERM, None)  # what a SIGTERM would do, without sending one
        requested.append(True)
        return out

    monkeypatch.setattr(Trainer, "step", step)
    result = _run(tmp_path, "stopped", chunks, 2)
    assert requested == [True] and result.iteration == 1
    files = sorted(os.listdir(tmp_path / "stopped"))
    assert "model-preempt-iter1.pt" in files and not any(f.startswith("model-epoch") for f in files)
    assert signal.getsignal(signal.SIGTERM) is before

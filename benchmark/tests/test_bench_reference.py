"""The plain reference (benchmark/reference) against the port on the CPU, at
nf 4 and 16^3 (32^3 where the 2D block needs room), on the same inputs and
weights: the generator, the raycaster, the depth chain, three full training
steps, and the chunked scene; and the frozen data generators against the
port's."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from gen.chunks import make_chunk_batch
from gen.scenes import make_room, served_room
from reference import chunked as ref_chunked
from reference import depth as ref_depth
from reference import raycast as ref_raycast
from reference.generator import Generator as RefGenerator
from spsg_tpu_torch.data import synthetic
from spsg_tpu_torch.inference import chunked
from spsg_tpu_torch.models.generator import Generator, GeneratorConfig
from spsg_tpu_torch.ops import depth as port_depth
from spsg_tpu_torch.ops import raycast as port_raycast
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training.step import Trainer


def _pair(nf=4, seed=0):
    torch.manual_seed(seed)
    port = Generator(GeneratorConfig(nf=nf))
    ref = RefGenerator(nf)
    ref.load_state_dict(port.state_dict())
    return port, ref


@pytest.mark.parametrize("train", [True, False])
def test_generator_matches_the_port(train):
    port, ref = _pair()
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(-3, 3, (2, 16, 16, 16, 4)).astype(np.float32))
    m = torch.as_tensor((rng.random((2, 16, 16, 16, 1)) < 0.3).astype(np.float32))
    port.train(train)
    ref.train(train)
    a = port(x, m, pred_color=True, pred_semantic=True)
    b = ref(x, m, pred_color=True, pred_semantic=True)
    for u, v in zip(a, b):
        assert u.shape == v.shape
        torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-5)
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=1e-5, atol=1e-6)


def test_chunk_batch_is_the_ports():
    """The room recipe on the device is the port's numpy recipe: geometry,
    labels, known space, masks and frames to the bit; the lab colours (torch's
    powers against numpy's) within a few units in the last place."""
    close = {"input": 1e-6, "target_colors": 1e-4, "images_color": 1e-6}
    for dims, image, seed in (((32, 32, 32), (48, 32), 7), ((128, 64, 64), (80, 64), 2 ** 33 + 5)):
        ours = make_chunk_batch(2, dims, image, seed=seed, device="cpu")
        theirs = synthetic.make_chunk_batch(2, dims, image, seed=seed, with_frames=True,
                                            device="cpu")
        theirs.pop("name")
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
            if k in close:
                np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=close[k], err_msg=k)
            else:
                np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_raycast_and_depth_chain_are_the_ports_plain_versions():
    b = make_chunk_batch(2, (32, 32, 32), (48, 32), seed=3, device="cpu")
    sdf = torch.as_tensor(np.clip(b["target_sdf"], -3, 3))
    valid = sdf.abs() < 3
    view, intr = torch.as_tensor(b["images_view"]), torch.as_tensor(b["images_intrinsic"])
    cfg = dict(width=48, height=32, depth_min=5.0, depth_max=300.0, ray_increment=0.9,
               thresh_sample_dist=50.5 * 0.9)
    h_ref = ref_raycast.find_surface_crossings(sdf, valid, view, intr,
                                               ref_raycast.RaycastConfig(**cfg))
    h_port = port_raycast.find_surface_crossings(sdf, valid, view, intr,
                                                 port_raycast.RaycastConfig(**cfg))
    assert bool(h_ref["hit"].any())
    for k in h_ref:
        assert torch.equal(h_ref[k], h_port[k]), k
    depth = torch.as_tensor(b["images_depth"])
    depth[:, 10:14, 20:25] = 0.0  # holes for the fill
    a = ref_depth.depth_to_normals_plain(depth, intr, 40)
    p = port_depth.depth_to_normals(depth, intr, 40)
    for u, v in zip(a, p):
        assert torch.equal(u, v)


def _train_pair(seed=2):
    cfg = TrainConfig(input_dim=(32, 32, 32), nf_gen=4, nf_disc=4, style_width=48,
                      style_height=32, patch_size=16)
    trainer = Trainer(cfg, device="cpu", seed=seed)
    weights = dict(gen={k: v.clone() for k, v in trainer.generator.state_dict().items()},
                   disc={k: v.clone() for k, v in trainer.discriminator.state_dict().items()},
                   sn=copy.deepcopy({k: {n: t.cpu() for n, t in d.items()}
                                     for k, d in trainer.sn_state.items()}))
    return cfg, trainer, weights


def test_three_training_steps_match_the_port():
    from drivers_train import compare, first_steps, reference_snapshot

    cfg, trainer, weights = _train_pair()
    pool = [make_chunk_batch(2, (32, 32, 32), (48, 32), seed=s, device="cpu") for s in (5, 6, 7)]
    flags = StepFlags.for_iter(cfg.num_iters_geo_only + 1, cfg)
    assert flags.use_2d and flags.use_disc

    def step(b):
        m = trainer.step(dict(b, weight_occ=np.float32(cfg.weight_occ_loss)), flags)
        return {k: float(v) for k, v in m.items()}

    snap = first_steps(pool, trainer, step)
    conf = dict(train=dataclasses.asdict(cfg), iteration=cfg.num_iters_geo_only + 1)
    ref = reference_snapshot(conf, weights, pool, "cpu")
    numbers = compare(snap, ref)
    assert numbers["loss_gap.step1"] < 1e-5
    assert numbers["grad1_gap"] < 1e-3
    assert numbers["change3_gap"] < 5e-2
    assert numbers["loss_gap.step3"] < 5e-3
    assert numbers["loss_disc_gap.step1"] < 1e-5
    assert numbers["disc_grad1_gap"] < 1e-3
    assert numbers["disc_change3_gap"] < 5e-2
    assert numbers["sn_change3_gap"] < 5e-2


def test_chunked_scene_matches_the_port():
    port, ref = _pair(nf=4, seed=4)
    room = served_room((32, 48, 40), 11, "cpu", dict(chunk_footprint=(32, 32),
                                                     objects_per_chunk=3, holes_per_chunk=2))
    kw = dict(truncation=3.0, chunk_dims=(32, 32, 32), stride=16, pad=2, max_height=32,
              window_batch=3)
    out = chunked.run_chunked_inference(
        port, None, None, room["target_sdf"], room["known"], room["semantics"],
        compact_scene=dict(sdf=room["sdf_input"], colors=room["input_colors"], color_space="lab"),
        device="cpu", **kw)
    r = ref_chunked.run_chunked(ref, room["sdf_input"], room["input_colors"], room["target_sdf"],
                                room["known"], room["semantics"], device="cpu", **kw)
    fin = np.isfinite(r.sdf)
    assert fin.any()
    np.testing.assert_array_equal(np.isfinite(out.sdf), fin)
    np.testing.assert_allclose(out.sdf[fin], r.sdf[fin], atol=1e-4)
    np.testing.assert_array_equal(out.occ, r.occ)
    assert np.abs(out.colors.astype(int) - r.colors.astype(int)).max() <= 1
    assert (out.sem_labels != r.sem_labels).mean() < 1e-3
    assert out.geo_intersection == r.geo_intersection and out.geo_union == r.geo_union


def test_rooms_repeat_from_their_seed():
    a = make_room((16, 64, 96), 5, "cpu")
    b = make_room((16, 64, 96), 5, "cpu")
    c = make_room((16, 64, 96), 6, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["target_sdf"], c["target_sdf"])
    assert a["input_colors"].dtype == torch.uint8 and a["sdf_input"].dtype == torch.float32
    assert bool(torch.isneginf(a["sdf_input"]).any()) and bool((a["target_sdf"].abs() < 1).any())


def test_a_served_room_has_the_chunks_density():
    """A served room carries the chunk recipe's objects and holes for each
    chunk footprint it spans: a room of four footprints has four chunks'
    worth of furniture labels and of carved voxels, within the draw's spread."""
    t = dict(chunk_footprint=(32, 32), objects_per_chunk=3, holes_per_chunk=2)
    big = [served_room((32, 64, 64), s, "cpu", t) for s in range(6)]
    small = [served_room((32, 32, 32), s, "cpu", t) for s in range(6)]

    def share(rooms, f):
        return float(np.mean([f(r) for r in rooms]))

    furniture = lambda r: np.isin(r["semantics"], (1, 4, 6, 7, 9, 10)).mean()  # noqa: E731
    carved = lambda r: (np.isneginf(r["sdf_input"]) & (np.abs(r["target_sdf"]) < 6)).mean()  # noqa: E731
    assert 0.4 < share(big, furniture) / share(small, furniture) < 2.5
    assert 0.4 < share(big, carved) / share(small, carved) < 2.5

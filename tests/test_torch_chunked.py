"""The port's chunked whole-scene inference (spsg_tpu_torch/inference/chunked.py)
against the JAX package's, on the CPU at 16^3 windows / nf=4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import pipeline as jpipeline, synthetic as jsynthetic
from spsg_tpu.inference import chunked as jchunked
from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu_torch.data import pipeline, synthetic
from spsg_tpu_torch.inference import chunked

import torch_port_helpers as H

CHUNK = H.CHUNK
KW = dict(chunk_dims=CHUNK, stride=8, pad=2, max_height=CHUNK[0])


def _sample(dims, seed):
    s = synthetic.make_scene(dims=dims, seed=seed)
    return pipeline.assemble_sample(
        s.sdf_input, s.sdf_complete, s.input_colors, s.colors, s.semantics,
        s.known, s.world2grid, 3.0, "lab", None)


def test_synthetic_scene_and_sample_equal_the_jax_package():
    """The copied numpy modules still produce the JAX package's data."""
    a = _sample((16, 40, 48), 4)
    s = jsynthetic.make_scene(dims=(16, 40, 48), seed=4)
    b = jpipeline.assemble_sample(
        s.sdf_input, s.sdf_complete, s.input_colors, s.colors, s.semantics,
        s.known, s.world2grid, 3.0, "lab", None)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def _jax_window_outputs(variables, sample, window_batch):
    """The JAX generator's outputs per window batch, windows cut as
    run_chunked_inference cuts them."""
    gen = JaxGenerator(JaxGeneratorConfig(nf=4))
    fwd = jax.jit(lambda v, c, m: gen.apply(
        v, c, m, pred_color=True, pred_sdf=True, pred_semantic=True, train=False))
    cz, cy, cx = CHUNK
    Z, Y, X = sample["input"].shape[:3]
    widths = ((0, 0), (0, cy), (0, cx), (0, 0))
    sin = np.pad(sample["input"].astype(np.float32), widths)
    sin[:, Y:, :, 0] = -3.0
    sin[:, :, X:, 0] = -3.0
    smask = np.pad(sample["mask"].astype(np.float32), widths)
    positions = [tuple(int(v) for v in p) for p in chunked.window_positions((Y, X), KW["stride"])]
    for start in range(0, len(positions), window_batch):
        pos = positions[start:start + window_batch]
        n_real = len(pos)
        pos = pos + [(0, 0)] * (window_batch - n_real)
        cb = np.stack([sin[:cz, y:y + cy, x:x + cx] for y, x in pos])
        mb = np.stack([smask[:cz, y:y + cy, x:x + cx] for y, x in pos])
        outs = fwd(variables, jnp.asarray(cb), jnp.asarray(mb))
        yield (pos, n_real) + tuple(np.asarray(o) for o in outs)


@pytest.mark.parametrize("weights", ["initial", "trained"])
def test_stitcher_matches_jax_on_identical_network_outputs(weights):
    """Fed the JAX generator's own outputs, the port's stitcher gives the JAX
    stitcher's integers exactly (no threshold can flip: the inputs are the
    same bits) and its float sums to add-order rounding."""
    v = H.initial_variables() if weights == "initial" else H.epoch39_variables()
    sample = _sample((16, 40, 48), 4)
    gen = JaxGenerator(JaxGeneratorConfig(nf=4))
    ref = jchunked.run_chunked_inference(
        gen, v, sample["input"], sample["mask"], sample["target_sdf"],
        sample["known"], sample["semantics"], window_batch=4, stitch_slices=True, **KW)
    got = chunked.stitch_window_outputs(
        _jax_window_outputs(v, sample, 4), sample["input"].shape[:3],
        sample["target_sdf"], sample["known"], sample["semantics"],
        chunk_dims=CHUNK, stride=8, pad=2, device="cpu")
    assert got.counts.dtype == ref.counts.dtype and got.counts.max() >= 2
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_array_equal(got.occ, ref.occ)
    assert got.geo_intersection == ref.geo_intersection
    assert got.geo_union == ref.geo_union and got.geo_union > 0
    np.testing.assert_array_equal(got.class_intersection, ref.class_intersection)
    np.testing.assert_array_equal(got.class_union, ref.class_union)
    np.testing.assert_array_equal(got.class_weight, ref.class_weight)
    cov = ref.counts > 0
    np.testing.assert_array_equal(np.isneginf(got.sdf), ~cov)
    np.testing.assert_allclose(got.sdf[cov], ref.sdf[cov], atol=1e-5)
    # colors are rounded to u8 after the division: a last-bit difference of
    # the float sum can move a value across a .5 boundary
    assert np.abs(got.colors.astype(np.int16) - ref.colors.astype(np.int16)).max() <= 1
    assert (got.colors == ref.colors).mean() > 0.999
    assert (got.sem_labels[cov] == ref.sem_labels[cov]).mean() > 0.999
    assert not got.colors[~cov].any()


def test_whole_slice_matches_jax_with_trained_weights():
    """Generator and stitcher together. A voxel whose occupancy logit or SDF is
    a rounding away from a threshold may flip between frameworks, so coverage
    is compared as a share of voxels."""
    v = H.epoch39_variables()
    sample = _sample((16, 40, 48), 4)
    args = (sample["input"], sample["mask"], sample["target_sdf"], sample["known"],
            sample["semantics"])
    ref = jchunked.run_chunked_inference(
        JaxGenerator(JaxGeneratorConfig(nf=4)), v, *args, window_batch=4, **KW)
    got = chunked.run_chunked_inference(
        H.torch_generator(v), *args, window_batch=4, device="cpu", **KW)
    assert got.sdf.shape == (16, 40, 48) and got.counts.max() >= 2
    same = got.counts == ref.counts
    assert same.mean() >= 0.999
    both = same & (ref.counts > 0)
    assert both.sum() > 1000
    np.testing.assert_allclose(got.sdf[both], ref.sdf[both], atol=1e-3)
    s_got, s_ref = (chunked.summarize_iou(
        o.geo_intersection, o.geo_union, o.class_intersection, o.class_union, o.class_weight)
        for o in (got, ref))
    assert abs(s_got["geo_iou"] - s_ref["geo_iou"]) <= 0.005
    assert abs(s_got["mean_iou"] - s_ref["mean_iou"]) <= 0.005
    np.testing.assert_array_equal(got.class_weight, ref.class_weight)
    assert np.abs(got.colors[both].astype(int) - ref.colors[both].astype(int)).max() <= 1


def _port_setup(seed=0):
    from spsg_tpu_torch.training import TrainConfig
    from spsg_tpu_torch.training.state import init_generator

    cfg = TrainConfig(input_dim=CHUNK, nf_gen=4, weight_disc_loss=0.0)
    return init_generator(cfg, torch.Generator().manual_seed(seed), device="cpu")


def test_single_window_matches_direct_forward():
    gen = _port_setup()
    sample = _sample(CHUNK, 3)
    out = chunked.run_chunked_inference(
        gen, sample["input"], sample["mask"], sample["target_sdf"], sample["known"],
        sample["semantics"], chunk_dims=CHUNK, stride=CHUNK[1], pad=2,
        max_height=CHUNK[0], window_batch=1, device="cpu")
    assert gen.training  # inference ran in eval mode and restored the mode it found
    with torch.no_grad():
        occ_l, sdf_p, _, _ = gen.eval()(
            H.t(sample["input"][None]), H.t(sample["mask"][None]), True, True, True)
    sdf_p = sdf_p.numpy()[0, ..., 0]
    occ_l = occ_l.numpy()[0, ..., 0]
    surf = (np.abs(sdf_p) < 3.0) & (torch.sigmoid(torch.from_numpy(occ_l)).numpy() > 0.5)
    np.testing.assert_array_equal(out.counts > 0, surf)
    np.testing.assert_allclose(out.sdf[surf], sdf_p[surf], atol=1e-6)


def test_window_batch_size_invariance():
    """Results must not depend on how windows are batched, in particular when
    the window count is not a multiple of window_batch."""
    gen = _port_setup()
    sample = _sample((16, 40, 48), 4)
    outs = {}
    for wb in (7, 64):
        outs[wb] = chunked.run_chunked_inference(
            gen, sample["input"], sample["mask"], sample["target_sdf"], sample["known"],
            sample["semantics"], window_batch=wb, device="cpu", **KW)
    a, b = outs[7], outs[64]
    np.testing.assert_array_equal(a.counts, b.counts)
    got = a.counts > 0
    np.testing.assert_allclose(a.sdf[got], b.sdf[got], atol=1e-6)
    assert a.geo_union == b.geo_union and a.geo_intersection == b.geo_intersection
    np.testing.assert_array_equal(a.class_union, b.class_union)


@pytest.mark.parametrize("kw", [
    dict(compact_scene={"sdf": np.zeros((16, 16, 16), np.float32),
                        "colors": np.zeros((16, 16, 16, 3), np.float32)}),
    dict(mesh=object())])
def test_unported_options_raise(kw):
    """mesh= takes the port's parallel.Mesh (tests/test_torch_parallel_serving.py)
    and refuses anything else; compact_scene is ported
    (tests/test_torch_compact_feed.py) and refuses float colours, as the JAX
    package does."""
    gen = _port_setup()
    sample = _sample(CHUNK, 3)
    err, match = ((TypeError, "parallel.Mesh") if "mesh" in kw
                  else (TypeError, "must be uint8"))
    with pytest.raises(err, match=match):
        chunked.run_chunked_inference(
            gen, sample["input"], sample["mask"], None, None, None,
            chunk_dims=CHUNK, device="cpu", **kw)


def test_iou_summary_and_txt_equal_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    cls_u = rng.integers(0, 50, 14)
    cls_i = (cls_u * rng.uniform(0, 1, 14)).astype(np.int64)
    cls_w = rng.integers(0, 80, 14)
    a = chunked.summarize_iou(30, 70, cls_i, cls_u, cls_w)
    b = jchunked.summarize_iou(30, 70, cls_i, cls_u, cls_w)
    assert a["geo_iou"] == b["geo_iou"] and a["mean_iou"] == b["mean_iou"]
    chunked.write_iou_txt(str(tmp_path / "a.txt"), a)
    jchunked.write_iou_txt(str(tmp_path / "b.txt"), b)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()

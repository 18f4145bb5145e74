"""compact_scene / --compact_feed of the port's chunked inference: the raw
scene (float SDF, uint8 RGB) assembled on the device
(inference/chunked.py::prep_compact_scene) against the host assembly of
data/pipeline.py and against the JAX package's compact path, on the CPU at
16^3 windows / nf=4. Ports tests/test_chunked_inference.py::
test_compact_feed_matches_host_assembly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.inference import chunked as jchunked
from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu_torch.cli import test_scene_as_chunks as cli
from spsg_tpu_torch.data import pipeline, synthetic
from spsg_tpu_torch.inference import chunked

import torch_port_helpers as H

CHUNK = H.CHUNK
KW = dict(chunk_dims=CHUNK, stride=8, pad=2, max_height=CHUNK[0], window_batch=4)


def _scene(dims, seed):
    s = synthetic.make_scene(dims=dims, seed=seed)
    sample = pipeline.assemble_sample(
        s.sdf_input, s.sdf_complete, s.input_colors, s.colors, s.semantics, s.known,
        s.world2grid, 3.0, "lab", None)
    return s, sample


def _compact(s, color_space="lab"):
    return dict(sdf=s.sdf_input.astype(np.float32), colors=s.input_colors,
                color_space=color_space)


def _assert_close(got, ref):
    """Coverage may flip only on sigmoid-boundary voxels of the untrained
    model; everything decidedly covered agrees (the JAX test's criteria)."""
    agree = ref.counts == got.counts
    assert agree.mean() > 0.999
    both = (ref.counts > 0) & (got.counts > 0) & agree
    assert both.sum() > 1000
    np.testing.assert_allclose(got.sdf[both], ref.sdf[both], atol=1e-4)
    assert np.abs(got.colors[both].astype(np.int32)
                  - ref.colors[both].astype(np.int32)).max() <= 1  # u8 after LAB encoding


def test_compact_feed_matches_host_assembly():
    s, sample = _scene((16, 40, 48), 5)
    gen = H.torch_generator(H.initial_variables())
    ref = chunked.run_chunked_inference(gen, sample["input"], sample["mask"], None, None, None,
                                        device="cpu", **KW)
    got = chunked.run_chunked_inference(gen, None, None, None, None, None,
                                        compact_scene=_compact(s), device="cpu", **KW)
    _assert_close(got, ref)


def test_compact_feed_matches_the_jax_compact_feed():
    """The port's compact path against the JAX package's on the same raw
    scene and weights (the trained nf=4 checkpoint, which covers the scene),
    with the IoU targets."""
    s, sample = _scene((16, 40, 48), 6)
    v = H.epoch39_variables()
    targets = (sample["target_sdf"], sample["known"], sample["semantics"])
    ref = jchunked.run_chunked_inference(
        JaxGenerator(JaxGeneratorConfig(nf=4)), v, None, None, *targets,
        compact_scene=_compact(s), stitch_slices=True, **KW)
    got = chunked.run_chunked_inference(H.torch_generator(v), None, None, *targets,
                                        compact_scene=_compact(s), device="cpu", **KW)
    _assert_close(got, ref)
    np.testing.assert_allclose(got.geo_union, ref.geo_union, rtol=0.01)
    np.testing.assert_allclose(got.geo_intersection, ref.geo_intersection, rtol=0.01)


@pytest.mark.parametrize("color_space", ["lab", "rgb"])
def test_prep_compact_scene_matches_jax(color_space):
    """The assembly itself: the clamped SDF, the fills and the mask identical
    to the JAX package's, the encoded colours within 1e-6 (float LAB); raw SDF
    values beyond the truncation and -inf included."""
    rng = np.random.default_rng(3)
    zyx, pads = (6, 10, 12), (2, 16, 16)
    sdf = rng.normal(0, 4, zyx).astype(np.float32)
    sdf[0, 0, :3] = -np.inf
    rgb = rng.integers(0, 256, zyx + (3,), dtype=np.uint8)
    lab = color_space == "lab"
    want = jchunked._prep_compact_scene(jnp.asarray(sdf), jnp.asarray(rgb), truncation=3.0,
                                        lab=lab, zyx=zyx, pads=pads)
    got = chunked.prep_compact_scene(torch.from_numpy(sdf), torch.from_numpy(rgb), 3.0, lab,
                                     pads)
    (gs, gm), (ws, wm) = [(a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
                          for a in got], [np.asarray(a) for a in want]
    assert gs.shape == ws.shape == (8, 26, 28, 4) and gm.shape == wm.shape
    assert np.array_equal(gs[..., 0], ws[..., 0]) and np.array_equal(gm, wm)
    np.testing.assert_allclose(gs[..., 1:], ws[..., 1:], rtol=0, atol=1e-6)


def test_compact_scene_dtype_checks_as_in_jax():
    """Float colours would be truncated by a cast, not divided by 255; an
    integer SDF is not a TSDF: both raise TypeError before any work."""
    s, _ = _scene((16, 16, 16), 1)
    bad = [dict(_compact(s), colors=s.input_colors.astype(np.float32)),
           dict(_compact(s), sdf=s.sdf_input.astype(np.int32))]
    for compact in bad:
        with pytest.raises(TypeError):
            jchunked.run_chunked_inference(JaxGenerator(JaxGeneratorConfig(nf=4)), {}, None,
                                           None, None, None, None, compact_scene=compact, **KW)
        with pytest.raises(TypeError, match="compact_scene"):
            chunked.run_chunked_inference(None, None, None, None, None, None,
                                          compact_scene=compact, device="cpu", **KW)


def test_compact_feed_crops_and_skips_on_the_raw_scene():
    """A scene taller than max_height is cropped on the raw arrays, and
    skip_empty_windows tests the raw SDF: the same windows and outputs as the
    host assembly with the same options."""
    s, sample = _scene((24, 40, 48), 7)
    s.sdf_input[:, 20:] = 5.0  # windows whose input is all empty
    sample = pipeline.assemble_sample(
        s.sdf_input, s.sdf_complete, s.input_colors, s.colors, s.semantics, s.known,
        s.world2grid, 3.0, "lab", None)
    gen = H.torch_generator(H.initial_variables())
    kw = dict(KW, skip_empty_windows=True)
    ref = chunked.run_chunked_inference(gen, sample["input"], sample["mask"],
                                        sample["target_sdf"], None, None, device="cpu", **kw)
    got = chunked.run_chunked_inference(gen, None, None, sample["target_sdf"], None, None,
                                        compact_scene=_compact(s), device="cpu", **kw)
    assert got.sdf.shape == ref.sdf.shape == (16, 40, 48)
    assert not (ref.counts[:, 30:] > 0).any()
    _assert_close(got, ref)


def test_cli_compact_feed_agrees_with_the_host_feed(tmp_path):
    args = ["--device", "cpu", "--synthetic_scenes", "1", "--input_dim", "16", "--nf_gen", "4",
            "--stride", "8", "--num_to_vis", "0"]
    host = cli.main(args + ["--output", str(tmp_path / "a")])
    compact = cli.main(args + ["--output", str(tmp_path / "b"), "--compact_feed"])
    assert abs(compact["geo_iou"] - host["geo_iou"]) <= 1e-3
    assert abs(compact["mean_iou"] - host["mean_iou"]) <= 1e-3

"""The port's single-shot whole-scene inference (spsg_tpu_torch/inference/
whole_scene.py) and the overhead renders of its CLI (cli/test_scene.py::
render_views) against the JAX package's, on the CPU at nf=4 on the scene of
tests/test_whole_scene.py."""

import numpy as np
import pytest
import torch

from spsg_tpu.cli import test_scene as jcli
from spsg_tpu.inference import whole_scene as jwhole
from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu.ops.raycast import RaycastConfig as JaxRaycastConfig
from spsg_tpu_torch.cli import test_scene as cli
from spsg_tpu_torch.data import pipeline, synthetic
from spsg_tpu_torch.inference import whole_scene
from spsg_tpu_torch.ops.raycast import RaycastConfig
from spsg_tpu_torch.parallel import make_mesh

import torch_port_helpers as H

TRUNC = 3.0
IMAGE = (48, 32)


def _sample():
    s = synthetic.make_scene(dims=(16, 64, 48), seed=11)
    return pipeline.assemble_sample(
        s.sdf_input, s.sdf_complete, s.input_colors, s.colors, s.semantics, s.known,
        s.world2grid, TRUNC, "lab", None)


@pytest.mark.parametrize("shape,max_height,y_multiple", [
    ((16, 64, 48), 16, 1), ((21, 30, 45), 16, 1), ((13, 30, 45), 128, 8), ((9, 7, 5), 0, 4)])
def test_pad_scene_is_the_jax_packages(shape, max_height, y_multiple):
    rng = np.random.default_rng(sum(shape))
    inp = rng.normal(0, 2, shape + (4,)).astype(np.float32)
    mask = (rng.uniform(0, 1, shape + (1,)) < 0.3).astype(np.float32)
    got = whole_scene.pad_scene(inp, mask, TRUNC, max_height, y_multiple=y_multiple)
    want = jwhole.pad_scene(inp, mask, TRUNC, max_height, y_multiple=y_multiple)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _jax_outputs(sample, v):
    return jwhole.run_whole_scene(JaxGenerator(JaxGeneratorConfig(nf=4)), v, sample["input"],
                                  sample["mask"], truncation=TRUNC, max_height=16)


@pytest.fixture(scope="module")
def scene_outputs():
    """The scene, the weights (JAX-initialised, BatchNorm randomised) and the
    JAX package's whole-scene outputs."""
    sample = _sample()
    v = H.random_variables(4, seed=2)
    return sample, v, _jax_outputs(sample, v)


@pytest.fixture(scope="module")
def trained_outputs(scene_outputs):
    """The JAX package's whole-scene outputs with the trained nf=4 checkpoint
    (random weights predict no surface to render)."""
    return _jax_outputs(scene_outputs[0], H.epoch39_variables())


def test_run_whole_scene_matches_jax(scene_outputs):
    """All four outputs within 1e-4 of the JAX package's; the generator comes
    back in the mode it was handed in."""
    sample, v, want = scene_outputs
    gen = H.torch_generator(v).train()
    got = whole_scene.run_whole_scene(gen, sample["input"], sample["mask"], truncation=TRUNC,
                                      max_height=16, device="cpu")
    assert gen.training
    for g, w, name in zip(got, want, ("occ", "sdf", "color", "semantic")):
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)
    assert got[0].shape == (16, 64, 48)
    geo = whole_scene.run_whole_scene(gen, sample["input"], sample["mask"], max_height=16,
                                      pred_color=False, pred_semantic=False, device="cpu")
    assert geo[2] is None and geo[3] is None
    np.testing.assert_array_equal(geo[1], got[1])


def test_mesh_raises_naming_the_roadmap(scene_outputs):
    """mesh= takes the port's parallel.Mesh and refuses anything else; the
    mesh of a process without a group (a world of one) gives the unsharded
    outputs to the bit (two ranks: tests/test_torch_parallel_serving.py)."""
    sample, v, _ = scene_outputs
    gen = H.torch_generator(v)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        whole_scene.run_whole_scene(gen, sample["input"], sample["mask"], mesh=object(),
                                    device="cpu")
    kw = dict(truncation=TRUNC, max_height=16, device="cpu")
    one = whole_scene.run_whole_scene(gen, sample["input"], sample["mask"], mesh=make_mesh(),
                                      **kw)
    for a, b in zip(one, whole_scene.run_whole_scene(gen, sample["input"], sample["mask"],
                                                     **kw)):
        np.testing.assert_array_equal(a, b)


def _grids(sample, outputs):
    """The CLI's three render inputs: (sdf, valid, colours in [0,1], semantic
    grid or None) of the input, the target and the prediction."""
    pad_inp, _, dims = whole_scene.pad_scene(sample["input"], sample["mask"], TRUNC, 16)
    in_sdf = pad_inp[..., 0]
    tz = dims[0]
    tgt = np.clip(sample["target_sdf"][:tz], -TRUNC, TRUNC)
    s14 = sample["semantics"][:tz].astype(np.int64)
    tsem = np.eye(15, dtype=np.float32)[s14][..., :14]
    _, sdf_p, color_p, sem_p = outputs
    return dims, {
        "input": (in_sdf, np.abs(in_sdf) < TRUNC, pad_inp[..., 1:4], None),
        "target": (tgt, np.abs(tgt) < TRUNC, sample["target_colors"][:tz] / 255.0, tsem),
        "prediction": (sdf_p, np.abs(sdf_p) < TRUNC, (color_p + 1.0) * 0.5, sem_p),
    }


@pytest.mark.parametrize("grid", ["input", "target", "prediction"])
def test_render_views_match_jax(scene_outputs, trained_outputs, grid):
    """The overhead render of each grid against the JAX CLI's render_views
    (48x32; the prediction of the trained checkpoint): hit masks equal up to
    ROADMAP.md Queue C's agreed share of the march (<= 1e-3 of the pixels),
    colour, normal and depth within 1e-5 where both hit, semantic labels
    identical there."""
    dims, grids = _grids(scene_outputs[0], trained_outputs)
    view, intr = cli.overhead_camera(dims, *IMAGE)
    jview, jintr = jcli.overhead_camera(dims, *IMAGE)
    assert np.array_equal(view, jview) and np.array_equal(intr, jintr)
    kw = dict(width=IMAGE[0], height=IMAGE[1], depth_min=0.1 / 0.02, depth_max=6.0 / 0.02,
              ray_increment=0.3 * TRUNC, thresh_sample_dist=50.5 * 0.3 * TRUNC)
    sdf, valid, col, sem = grids[grid]
    want = jcli.render_views(sdf, valid, col, sem, view, intr, JaxRaycastConfig(**kw))
    got = cli.render_views(sdf, valid, col, None if sem is None else torch.from_numpy(sem.copy()),
                           view, intr, RaycastConfig(**kw), device="cpu")
    assert got.keys() == want.keys()
    hit_g, hit_w = np.isfinite(got["depth"]), np.isfinite(want["depth"])
    assert hit_w.sum() > 20
    assert (hit_g != hit_w).mean() <= 1e-3
    both = hit_g & hit_w
    for k in ("color", "normal", "depth"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k][both], want[k][both], rtol=0, atol=1e-5, err_msg=k)
    if "semlabel" in want:
        np.testing.assert_array_equal(got["semlabel"][both], want["semlabel"][both])

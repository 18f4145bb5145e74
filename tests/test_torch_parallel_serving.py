"""The port's two servings with mesh= on two gloo ranks on the CPU
(tests/torch_parallel_worker.py), with the trained nf=4 checkpoint: chunked
windows split over the ranks (inference/chunked.py) and the scene split along
Y with halo exchanges (inference/whole_scene.py), each against the JAX
package's run on a 2-device mesh and against the port's one-process run."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from spsg_tpu.inference import chunked as jchunked
from spsg_tpu.inference import whole_scene as jwhole
from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu_torch.inference import chunked, whole_scene

import test_torch_chunked as C
import torch_parallel_worker as W
import torch_port_helpers as H

FIELDS = ("sdf", "colors", "sem_labels", "occ", "counts", "geo_intersection", "geo_union",
          "class_intersection", "class_union", "class_weight")


@pytest.fixture(scope="module")
def weights():
    v = H.epoch39_variables()
    gen = H.torch_generator(v)
    return v, gen, {f"gen/{k}": t.numpy() for k, t in gen.state_dict().items()}


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ("data",))


def test_chunked_inference_on_two_ranks(tmp_path, weights):
    """Each rank runs 2 of every 4 windows; rank 0 stitches and returns the
    scene, rank 1 None. The scene equals the one-process run to the bit, and
    the JAX package's run on a 2-device mesh by the rule of
    tests/test_torch_chunked.py::test_whole_slice_matches_jax_with_trained_weights."""
    v, gen, arrays = weights
    sample = C._sample((16, 40, 48), 4)
    args = (sample["input"], sample["mask"], sample["target_sdf"], sample["known"],
            sample["semantics"])
    kw = dict(C.KW, window_batch=4)
    W.save_inputs(tmp_path, dict(arrays, input=args[0], mask=args[1], target_sdf=args[2],
                                 known=args[3], semantics=args[4]),
                  nf=4, kw={k: list(x) if isinstance(x, tuple) else x for k, x in kw.items()})
    r0, r1 = W.run_ranks("chunked", tmp_path)
    assert set(r1) == {"none"}
    one = chunked.run_chunked_inference(gen, *args, device="cpu", **kw)
    for f in FIELDS:
        assert np.array_equal(r0[f], np.asarray(getattr(one, f))), f

    ref = jchunked.run_chunked_inference(JaxGenerator(JaxGeneratorConfig(nf=4)), v, *args,
                                         mesh=_jax_mesh(), **kw)
    same = r0["counts"] == ref.counts
    assert same.mean() >= 0.999
    both = same & (ref.counts > 0)
    assert both.sum() > 1000
    np.testing.assert_allclose(r0["sdf"][both], ref.sdf[both], atol=1e-3)
    s_got, s_ref = (chunked.summarize_iou(*(np.asarray(o[f]) for f in FIELDS[5:]))
                    for o in (r0, {f: getattr(ref, f) for f in FIELDS[5:]}))
    assert abs(s_got["geo_iou"] - s_ref["geo_iou"]) <= 0.005
    assert abs(s_got["mean_iou"] - s_ref["mean_iou"]) <= 0.005
    np.testing.assert_array_equal(r0["class_weight"], ref.class_weight)
    assert np.abs(r0["colors"][both].astype(int) - ref.colors[both].astype(int)).max() <= 1


# the generator's conv forms served Y-sharded beside the default one, in the
# same launch of the ranks
FORMS = {"zslab_conv": {"zslab_conv": True}, "folded_conv": {"folded_conv": True}}
SCENE_KW = dict(truncation=3.0, max_height=16)


@pytest.fixture(scope="module")
def whole_scene_ranks(tmp_path_factory, weights):
    """One launch of the two ranks: the whole scene of Y 14 with mesh=, by the
    default generator and by each of FORMS. Returns (sample, rank 0's results,
    rank 1's)."""
    _, _, arrays = weights
    sample = C._sample((16, 14, 48), 11)
    directory = tmp_path_factory.mktemp("whole_scene")
    W.save_inputs(directory, dict(arrays, input=sample["input"], mask=sample["mask"]),
                  nf=4, kw=SCENE_KW, forms={"": {}, **FORMS})
    r0, r1 = W.run_ranks("whole_scene", directory)
    return sample, r0, r1


def test_whole_scene_on_two_ranks(whole_scene_ranks, weights):
    """A scene of Y 14, padded to 16 (a multiple of 4 * 2 ranks): each rank a
    slab of 8 rows, 4 at half and 2 at quarter resolution, so that every conv
    reads across a slab edge and the 5^3 entry convs take two halo rows. Both
    ranks return the whole scene; it equals the port's unsharded forward on the
    same padded scene to the bit and the JAX package's Y-sharded run on a
    2-device mesh within 1e-4 (tests/test_torch_whole_scene.py's tolerance)."""
    v, gen, _ = weights
    sample, r0, r1 = whole_scene_ranks
    kw = SCENE_KW
    one = whole_scene.run_whole_scene(gen, sample["input"], sample["mask"], device="cpu", **kw)
    ref = jwhole.run_whole_scene(JaxGenerator(JaxGeneratorConfig(nf=4)), v, sample["input"],
                                 sample["mask"], mesh=_jax_mesh(), **kw)
    for name, o, w in zip(("occ", "sdf", "color", "semantic"), one, ref):
        assert r0[name].shape == o.shape == w.shape and o.shape[:3] == (16, 16, 48), name
        assert np.array_equal(r0[name], r1[name]), name
        assert np.array_equal(r0[name], o), name
        np.testing.assert_allclose(r0[name], w, rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_whole_scene_forms_on_two_ranks(whole_scene_ranks, weights, form):
    """The Y-sharded scene with zslab_conv (the 7 library convs as z-slab
    convs on the halo'd slab with Y padding 0) and with folded_conv (the two
    5^3 entry convs so): both ranks return the one-process run of the same
    generator to the bit."""
    v, _, _ = weights
    sample, r0, r1 = whole_scene_ranks
    gen = H.torch_generator(v, **FORMS[form])
    one = whole_scene.run_whole_scene(gen, sample["input"], sample["mask"], device="cpu",
                                      **SCENE_KW)
    for name, o in zip(("occ", "sdf", "color", "semantic"), one):
        got = r0[f"{form}/{name}"]
        assert got.shape == o.shape and np.array_equal(got, r1[f"{form}/{name}"]), name
        assert np.array_equal(got, o), (name, np.abs(got - o).max())

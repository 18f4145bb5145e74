"""The port's copies of the host-side data modules against the JAX package's
originals, and the torch half of the colour conversions against the jnp half."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import category as jcategory, colorspace as jcolorspace, formats as jformats
from spsg_tpu.training.config import StepFlags as JaxStepFlags, TrainConfig as JaxTrainConfig
from spsg_tpu_torch.data import category, colorspace, formats
from spsg_tpu_torch.training.config import StepFlags, TrainConfig

# one intra-op thread: the suite runs several workers side by side, and the JAX
# package's multi-device CPU tests abort when their collectives are starved
torch.set_num_threads(1)


@pytest.mark.parametrize("fn", ["rgb_to_lab", "lab_to_rgb", "rgb_to_lab01", "lab01_to_rgb"])
def test_lab_conversions_torch_numpy_jnp_agree(fn):
    rng = np.random.default_rng(0)
    a = rng.random((4, 5, 3)).astype(np.float32)
    if fn == "lab_to_rgb":
        a = jcolorspace.rgb_to_lab(a, xp=np).astype(np.float32)
    want_np = getattr(colorspace, fn)(a, xp=np)
    want_jnp = np.asarray(getattr(jcolorspace, fn)(jnp.asarray(a), xp=jnp))
    got = getattr(colorspace, fn)(torch.from_numpy(a), xp=torch)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    # float32 pow/cbrt of three libraries; LAB spans [0, 100]
    atol = 2e-3 if fn in ("rgb_to_lab",) else 1e-4
    np.testing.assert_allclose(got.numpy(), want_np, atol=atol)
    np.testing.assert_allclose(got.numpy(), want_jnp, atol=atol)


def test_lab_conversion_is_differentiable_in_torch():
    x = torch.rand(6, 3, dtype=torch.float64).clamp(0.05, 0.95).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: colorspace.rgb_to_lab01(t, xp=torch), (x,),
                                    atol=1e-5)


def test_hue_augmentation_equals_the_jax_package():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (3, 4, 5, 3), dtype=np.uint8)
    assert np.array_equal(colorspace.augment_hue_np(rgb, 1.3), jcolorspace.augment_hue_np(rgb, 1.3))


def test_category_tables_equal_the_jax_package():
    assert category.CLASS_NAMES == jcategory.CLASS_NAMES
    assert (category.NUM_CLASSES, category.UNLABELED) == (jcategory.NUM_CLASSES, jcategory.UNLABELED)
    assert np.array_equal(category.MAPPING_COLOR, jcategory.MAPPING_COLOR)
    lab = np.arange(15, dtype=np.uint8).reshape(3, 5)
    assert np.array_equal(category.map_label_to_color(lab), jcategory.map_label_to_color(lab))


def test_sdf_file_written_by_one_package_reads_in_the_other(tmp_path):
    rng = np.random.default_rng(2)
    dims = (6, 7, 8)
    sdf = rng.normal(0, 2, dims).astype(np.float32)
    locs, vals = formats.dense_to_sparse(sdf, 1.5)
    jl, jv = jformats.dense_to_sparse(sdf, 1.5)
    assert np.array_equal(locs, jl) and np.array_equal(vals, jv)
    dense = formats.sparse_to_dense(locs, vals, dims, -np.inf)
    assert np.array_equal(dense, jformats.sparse_to_dense(jl, jv, dims, -np.inf))
    sem = rng.integers(0, 15, dims).astype(np.uint8)
    formats.save_semantics(str(tmp_path / "a.sem"), sem)
    jformats.save_semantics(str(tmp_path / "b.sem"), sem)
    assert (tmp_path / "a.sem").read_bytes() == (tmp_path / "b.sem").read_bytes()
    assert np.array_equal(jformats.load_semantics(str(tmp_path / "a.sem")), sem)
    assert np.array_equal(formats.load_semantics(str(tmp_path / "b.sem")), sem)


def test_train_config_round_trips_between_the_packages():
    jcfg = JaxTrainConfig(nf_gen=4, input_dim=(16, 16, 16), fused_conv=True, march_group=2)
    cfg = TrainConfig.from_json(jcfg.to_json())
    assert cfg.to_json() == jcfg.to_json()
    assert JaxTrainConfig.from_json(cfg.to_json()) == jcfg
    assert (cfg.ray_increment, cfg.thresh_sample_dist, cfg.disc_nf_in) == (
        jcfg.ray_increment, jcfg.thresh_sample_dist, jcfg.disc_nf_in)
    for it in (0, 700, 1001, 60001):
        a, b = StepFlags.for_iter(it, cfg), JaxStepFlags.for_iter(it, jcfg)
        assert vars(a) == vars(b), it

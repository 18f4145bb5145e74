"""Training configuration (mirrors the reference argparse surface,
torch/train.py:32-107, as a frozen, hashable dataclass). Field for field the
same as the JAX package's, so ``to_json`` / ``from_json`` round-trip between
the two."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

GAN_TYPES = ("hinge", "vanilla", "wgan", "wgan_gp")
COLOR_SPACES = ("rgb", "lab")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # data
    input_dim: Tuple[int, int, int] = (128, 64, 64)  # (Z up, Y, X) train.py:110-111
    voxelsize: float = 0.02
    truncation: float = 3.0
    batch_size: int = 2
    use_loss_masking: bool = True
    color_space: str = "lab"
    input_mask: bool = True
    augment_rgb_scaling: bool = True
    augment_scale_min: float = 0.5
    augment_scale_max: float = 1.5
    color_truncation: float = 0.0
    color_thresh: float = 15.0
    # model
    nf_gen: int = 20
    nf_disc: int = 8
    pass_geo_feats: bool = True
    # optimization
    lr: float = 1e-4
    d_lr_factor: float = 4.0
    weight_decay: float = 0.0
    max_epoch: int = 10
    save_epoch: int = 1
    # curriculum (train.py:56-58)
    num_iters_geo_only: int = 1000
    num_iters_before_content: int = 60000
    # loss weights (train.py:59-103)
    weight_occ_loss: float = 1.0
    weight_sdf_loss: float = 0.1
    weight_depth_loss: float = 1.0
    weight_color_loss: float = 1.0
    weight_semantic_loss: float = 0.1
    pred_3d_semantic: bool = True
    weight_missing_geo: float = 5.0
    weight_surf_geo: float = 1.0
    weight_missing_color: float = 1.0
    weight_style_loss: float = 0.0
    weight_content_loss: float = 0.0
    weight_disc_loss: float = 0.5
    weight_discgen_loss: float = 0.005
    logweight_sdf: bool = True
    project_targets: bool = True
    filter_proj_tgt: bool = True
    weight_by_percent_pixels: bool = False
    # 2d rendering (train.py:86-91, 134-148)
    style_width: int = 320
    style_height: int = 256
    max_depth_fill_iters: int = 40
    raycast_depth_min: float = 0.1  # meters
    raycast_depth_max: float = 6.0  # meters
    # the occupancy raycaster used for the missing-color masks is built with
    # a shallower range than the color raycaster (train.py:146-148)
    raycast_occ_depth_max: float = 4.0  # meters
    # adversarial
    patch_disc: bool = True
    patch_size: int = 96
    disc_loss_type: str = "vanilla"
    valid_thresh: float = 0.1
    min_num_valid_2d: int = 2000  # train.py:662
    # compute
    compute_dtype: Optional[str] = None  # 'bfloat16': the generator's blocks (serving, training)
    # folded_conv, zslab_conv and remat below take effect (GeneratorConfig: the
    # generator's convs that the hand kernels do not take as z-slab 2D convs,
    # only the 5^3 entry convs with folded_conv; conv blocks rematerialised in
    # the backward). The other fields
    # below steer the JAX package's compiler and scheduling on its own
    # accelerator. This package accepts them, so that a stored config
    # round-trips between the two packages (in the same field order), and
    # gives them no effect: eligible 3x3x3 convs always take the CUDA kernels
    # of ops/conv3x3.py on a CUDA tensor (pallas_conv / fused_conv are
    # therefore moot), and layout and ray-march scheduling are decided by this
    # package.
    channels_first: bool = False
    pallas_conv: bool = False
    fused_conv: bool = False
    folded_conv: bool = False
    zslab_conv: bool = False
    compact_resid: bool = False
    remat: bool = False
    straggler_frac: float = 0.125
    march_block: int = 32
    coarse_hops: int = 4
    fuse_raycast: bool = False
    pair_raycast: bool = False
    compact_across_batch: bool = False
    march_group: int = 0
    # per-(chunk, frames) cache of the parameter-independent view
    # precomputation (input/target march hits + depth chain; the reference
    # recomputes them every step, train.py:563,590); capacity in entries,
    # 0 disables
    cache_renders: int = 0
    # exact reference skip semantics (train.py:539-541): when a frame's depth
    # holes cannot be filled, the reference `continue`s — no generator OR
    # discriminator step at all, 3D losses included. Default (False) keeps
    # the documented deviation of zeroing only the 2D terms (strictly more
    # data used); enable for exact-parity runs.
    skip_batch_on_bad_depth: bool = False

    def __post_init__(self):
        assert self.disc_loss_type in GAN_TYPES
        assert self.color_space in COLOR_SPACES

    @property
    def ray_increment(self) -> float:
        return 0.3 * self.truncation  # train.py:134

    @property
    def thresh_sample_dist(self) -> float:
        return 50.5 * self.ray_increment  # train.py:135

    @property
    def disc_nf_in(self) -> int:
        """Discriminator input channels (train.py:159-160): rendered
        color+normal for both the input render and the synth/target render."""
        per = 3 * (self.weight_depth_loss > 0) + 3 * (self.weight_color_loss > 0)
        return 2 * per

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        d = json.loads(s)
        d["input_dim"] = tuple(d["input_dim"])
        return TrainConfig(**d)


@dataclasses.dataclass(frozen=True)
class StepFlags:
    """Curriculum gates, resolved per-iteration by the host loop
    (reference train.py:450-456)."""

    pred_sdf: bool = True  # iter > 2/3 * num_iters_geo_only
    pred_color: bool = False  # iter > num_iters_geo_only
    pred_semantic: bool = False
    use_2d: bool = False  # iter > num_iters_geo_only and any 2D loss on
    use_disc: bool = False
    compute_style: bool = False  # iter > num_iters_before_content
    compute_content: bool = False
    train: bool = True  # False = validation pass (no optimizer updates)

    @staticmethod
    def for_iter(it: int, cfg: TrainConfig, have_frames: bool = True, train: bool = True) -> "StepFlags":
        geo = cfg.num_iters_geo_only
        use_disc = cfg.weight_disc_loss > 0
        # the whole 2D block needs the sparsified pred SDF, which the
        # reference only builds when weight_depth_loss > 0
        # (train.py:471-472, 524-525)
        any2d = cfg.weight_depth_loss > 0
        return StepFlags(
            pred_sdf=it > geo * 2 // 3 and cfg.weight_sdf_loss > 0,
            pred_color=it > geo
            and (
                cfg.weight_color_loss > 0
                or cfg.weight_style_loss > 0
                or cfg.weight_content_loss > 0
            ),
            pred_semantic=it > geo and cfg.weight_semantic_loss > 0,
            use_2d=it > geo and any2d and have_frames,
            use_disc=it > geo and any2d and use_disc and have_frames,
            compute_style=it > cfg.num_iters_before_content and cfg.weight_style_loss > 0,
            compute_content=it > cfg.num_iters_before_content and cfg.weight_content_loss > 0,
            train=train,
        )

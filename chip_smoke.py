#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spsg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device, nvcc, and nothing else (no network, no dataset, no
trained weights: everything is made from seeds). It exits with a code other
than 0, and without its last line, if there is no CUDA device or if any phase
fails. Phases, each printing one JSON line:

  device   the card (name and power limit as nvidia-smi gives them), versions
  build    builds the CUDA kernels from spsg_tpu_torch/ops/csrc with nvcc (one
           nvcc per source, started together); per kernel its registers and
           spills (ptxas) and its tensor-core instructions (HMMA, from
           cuobjdump -sass): every variant of the forward kernel and of the
           weight-gradient kernel must have some
  compare  (summary; the numbers are in the "kernels" line)
           every hand-written kernel against its plain PyTorch version, at a
           toy shape, an edge shape (ragged tiles, Cout > 104) and at the
           shapes the main paths give it (batch 1, and the (32,16,16) layer
           also at the paths' batches 8 and 2; the weight gradient also at the
           training batch's heaviest layer, (2,128,64,64) 100->40), in
           float32 and bfloat16 (the two forward kernels also at the whole-scene
           path's shapes: (1,128,160,192) 100->40 and 20->20, and
           (1,128,260,328) 100->40, whose input passes 2^32 bytes), with
           times: kernel, plain version, the one
           library call that computes the same function (F.conv3d, or
           torch.nn.grad.conv3d_weight for the weight gradient, in true
           float32; a yardstick, the port never calls it for these layers),
           and the least time the card could take (bound: float32 work at
           three TF32 tensor-core passes, 3 x flops / 495 TFLOP/s, the least
           time in which the card gives a float32-accurate product; bfloat16
           at 989 TFLOP/s; or the bytes at 3.35 TB/s). The forward kernel
           also at the shapes the backward gives it (dx: Cin and Cout swapped,
           Cin of 1, 3 and 14). Then the full backward of both autograd
           Functions with the kernels against the same Functions with the
           plain versions inside, at the heaviest layer
  compare_raycast
           the raycaster's four kernels against their plain versions, on the
           input, target and a noisy prediction grid of a make_chunk_batch with
           frames, at a toy size (16^3, 48x32) and at the training path's
           ((128,64,64), 320x256): the march (K4; hit, hit_idx, alpha and depth
           identical to the bit on every pixel, and its count of its work,
           per ray the lattice index at exit and the samples that loaded
           corners, equal to march_work_plain's), the shade (K5; identical to
           the bit, also on a ragged pixel count, the training step's input
           grid (semantic None, timed too), every attribute None, NaN and
           +-inf attributes, a row without a hit and a row of hits)
           and the scatter (K6; within 1e-5 of each gradient's largest entry,
           atomic adds in another order; also with every hit pixel on 8
           voxels), with device times (the calls queued behind a spin of the
           card, so a wrapper's host time does not count): kernel, plain
           version, a library yardstick (the gather by advanced indexing for
           K5, index_add_ + divide for K6, none for K4), the bound (bytes at
           3.35 TB/s; for K4 the larger of that and the lattice samples up to
           the exit whose cell is fully valid, plus the bisections, at 50
           float32 operations each at 67 TFLOP/s, counted by march_work_plain;
           the earlier bound, every lattice sample up to the exit, beside it;
           for K5 the rows of the voxels hit, each once; a row for each hit
           pixel, the earlier count, beside it); and the occupancy march (K7:
           its 8^3 map pre-pass and the hopping march) at the step's 4 m range
           on the step's two masks of the same batch (the target surface in
           8^3 blocks without input, the target's |sdf| < 1 band), an
           all-empty grid and three grids made to catch a wrong skip (one
           occupied voxel on a block corner, an axis-aligned camera whose
           rays run on a block face, a camera inside an occupied shell), at
           both sizes, and rays made to round onto a block face (rounding_rays):
           identical on every pixel, its lattice index at exit per ray equal
           to occ_march_plain's, its count of loaded samples (evaluated) equal
           to occ_march_work_plain's and its map to occ_skip_map_plain's; on
           the masks at the path's size and on the empty grid it loads fewer
           samples than it walks past; bound: the grid, the rays and the image
           at 3.35 TB/s, or the samples up to each ray's exit whose 8^3 block
           holds an occupied voxel at 20 float32 operations each (the earlier
           bound, every sample to the exit, beside it); no library yardstick;
           the ray set-up of raycast_occ must not wait for the card (torch's
           sync debug mode counts 0 host syncs)
  path     the serving path through the entry points a user calls: the
           whole-scene CLI at full width (nf_gen 20, windows (128,64,64),
           stride 32, window batch 8, colour and semantics) on one synthetic
           (128,160,192) scene with seeded random weights; checks the launch
           counters (23 fused + 5 bare convs per window batch, 4 batches), the
           outputs, IoU.txt; the same scene fed raw (compact_scene, the CLI's
           --compact_feed: the clamp, LAB and the mask on the card), counts
           agreeing with the host-assembled run on 99.9 % of the voxels, seconds
           of each; then one window batch with the kernels against
           the same batch with the kernels' plain versions, and a small scene
           on the GPU against the same scene on the CPU
  scene    the single-shot whole-scene CLI (spsg_tpu_torch.cli.test_scene) at its
           defaults (nf_gen 20, colour and semantics, max_input_height 128,
           480x384 overhead renders) on its synthetic (128,160,192) scene, the
           path's seeded weights written as a checkpoint of the original
           reference (.pth, its module names): launches K1 5, K3 23, K4 3, K5 3;
           the outputs (shapes, finite), the images and meshes written, every
           render hitting; seconds per scene (host clock around
           run_whole_scene, synchronised), voxels per second, each render's
           seconds, peak memory; the .pt of the same weights gives the same
           scene to the bit; the forward against its plain-conv twin (within
           1e-3) at the scene's shape and at the reference's default bound
           (128,260,328), with the latter's seconds and peak memory; device time
           of the forward by kind; one scene in bfloat16 (seconds, peak memory,
           its difference from float32, device time by kind); K4 and K5 against their plain
           versions on the prediction's render (identical to the bit), with
           times and bounds
  train    the 3D-loss training path: Trainer(TrainConfig()) at full width (nf_gen 20,
           chunks (128,64,64), batch 2, Adam) on synthetic chunks with seeded
           weights, 3D losses with colour and semantics switched on: the
           forward runs all 28 eligible convs, the backward crosses 25 of them
           (without 2D losses nothing reaches the three convs of the colour
           head, in the JAX package as here). One step with the kernels
           against the same step of a twin whose convs are the plain versions
           differentiated by autograd (metrics and every parameter gradient);
           launch counters per step (23 fused forward, 5 + 25 bare forward and
           dx, 25 dW; geometry-only flags: 9, 2 + 11, 11); three more steps
           (finite, parameters and running statistics move), timed; device
           time of one step by kind of kernel; a 16^3 / nf 4 step on the GPU
           against the same step on the CPU
  train2d  the full default training step (use_2d, use_disc: normals, three
           raycasts, the depth chain, 2D losses, the discriminator's update and
           the adversarial term) of Trainer(TrainConfig()) at full width (nf_gen
           20, (128,64,64), batch 2, one 320x256 frame a chunk rendered on the
           card, nf_disc 8, patch 96, vanilla GAN), weights as in train. Checks
           that the step ran with its gate open (num_valid against
           min_num_valid_2d, the discriminator stepped), the launch counters per
           step (23 fused, 5 + 28 bare forward and dx, 28 dW: the 2D losses reach
           the colour head; K4 3, K5 3, K6 1) and the depth chain's host reads;
           one step against a twin with the plain convs and the plain raycaster
           (metrics, every parameter gradient of the generator; the
           discriminator's reported; prediction pixels whose hit differs, counted); one warm-up
           and three timed steps (median seconds, peak memory); a validation pass
           changes nothing; device time of one step by kind; one full step with
           weight_missing_color 2 (launches as above and K7 2) against its
           plain twin, and precompute_views on the same batch identical to the
           bit to what that step computed (hits, normals, frames_ok, masks);
           a 16^3 / nf 4 / 48x32 full step on the GPU against the same step
           on the CPU
  metrics  the metrics CLI (spsg_tpu_torch.cli.metrics, on the card) over the scene
           phase's outputs, before its temporary directory goes: chamfer and IoU
           on its meshes, SSIM and Feature-l1 on its prediction and target
           renders (480x384), FID between its four prediction and four target
           renders; the versions of scipy, PIL, pandas and matplotlib; no hand
           kernel launched; Inception-v3 on the eight renders: seconds per
           image (host clock, one forward an image, synchronised by the copy
           back), peak memory, device time of one image; its pool features,
           its logits and Feature-l1 on the card against the CPU's, within 1e-4
           of the largest entry
  train2d_style
           the full step with the VGG style / content losses (Trainer(...,
           vgg=...), TrainConfig() width, both weights 1 and both flags on,
           LAB colour, the VGG on its fixed-seed weights): the launch counters
           as in train2d, loss_style / loss_content finite and positive, the
           same step with both weights 0 (the same forward within 1e-5, the
           generator's gradients apart by more than 1e-3 of a leaf's largest
           entry: the style gradient reaches the generator through K5 / K6);
           one warm-up and three timed steps (median seconds, peak memory);
           device time of one step by kind, the style block traced alone and
           moved into "vgg" (both VGG forwards, the backward to the render, the
           Gram products, the LAB conversion); the VGG forward at 320x256 on
           the card against the CPU's, within 1e-4 of the largest |feature|; a
           16^3 / nf 4 / 48x32 style step on the GPU against the CPU
  train_cli
           the train CLI as a user calls it (spsg_tpu_torch.cli.train.main, in
           this process) at TrainConfig() width on 10 synthetic chunks in
           batches of 2 for 3 epochs (5 iterations each), the first iteration
           geometry-only, the other 14 full steps, a render cache of 10 (the
           first epoch's full steps miss it whole, the third epoch's hit it
           whole): args.txt, log_val.csv (its header, 3 finite rows, the 2D
           and adversarial losses in the last), model-epoch0-2.pt; K4 once in
           every cached step, twice in a lookup that recomputes; seconds per
           iteration by kind (geometry-only, the first full step, whole cache
           miss, partial, whole hit; median, range and count, at least 3 whole
           misses and 3 whole hits), the loop's host time outside the step, one
           checkpoint write (seconds, bytes), peak memory. The launch counts
           are set to 0 as run_training starts, after the CLI synthesised its
           chunks. Then the third epoch again, resumed from model-epoch1.pt:
           the same iteration, epoch and Adam step counts, the parameters held
           to Queue C's Adam rule
  train2d_bf16
           the full step of train2d at TrainConfig() width with
           compute_dtype="bfloat16" (the generator's blocks in bf16; its
           parameters, Adam state, heads and losses and the discriminator in
           float32): the launches as in train2d, every block's conv through the
           bf16 variants of K1-K3 and the four heads' (4 forward, 4 dx, 4 dW) in
           float32, counted by storage type; parameters and Adam state finite
           float32; its metrics against the float32 step's on the same batch and
           weights (3D within 1e-2 relative, 2D and adversarial within 5e-2:
           ROADMAP.md Queue C); one warm-up and three timed steps (median
           seconds, peak memory); device time by kind beside train2d's; the
           16^3 / nf 4 / 48x32 bf16 step on the GPU against the CPU, same bounds
  datagen  dataset generation on the card: a seeded 6.0 x 5.0 x 2.8 m room
           (floor, four walls, no ceiling, 12 boxes, faces cut to ~0.1 m: ~25k
           faces, vertex colours), virtual_scan at 2 cm voxels (grid
           (146,256,306), 274 MB of state) along 96 frames on a 1.2 m circle at
           1.5 m looking outward and down, 320x256 at ScanConfig's intrinsics,
           chance_drop_frames 0.8: K8 once a frame; the native rasterizer loaded;
           seconds of the scan, per frame the host rasterizer, the upload and
           K8's device time (8 frames, queued behind a spin), its cull (the
           box, the voxels its rows' intervals hold, the host's time to find
           them), save_grid's seconds, peak memory; the scan's frames replayed
           through K8 and integrate_plain on the card: identical to the bit
           (all four fields) after 8 frames and at the end, and the end equal
           to the scan's own grid; then frames made to catch a wrong cull
           (cameras along +x and straight down, grazing a face, in a corner of
           the grid, looking away from it, a voxel on the optical axis at pz =
           5e-10), each identical to the bit, one launch each, the cull empty
           exactly when nothing changed; K8's bound: per frame the voxels
           with a valid depth (sdf, weight, free_ctr, colour: 24 bytes read
           and written) and both images at 3.35 TB/s, no library
           yardstick; a small scan (floor, voxel 0.08, 6 frames) through the
           CLI on the GPU and the CPU: the six files
           identical byte for byte; then the CLI on the card: scan at its
           defaults on the room written as PLY (K8 48 times), chunk of the
           room's __inc__ / __cmp__ at (128,64,64), semantics from a labeled
           region PLY, filelist; one chunk through data/pipeline.ChunkDataset
           with the shapes of a training chunk. category (matplotlib) is not
           driven: a line says so
  conv_forms
           the three forms of the convs the hand kernels do not take (F.conv3d;
           z-slab 2D convs, ops/zslab_conv.py; output-folded patch products,
           ops/folded_conv.py, on the two 5^3 entry convs), GeneratorConfig's
           zslab_conv (all seven as z-slab convs) and folded_conv (the two 5^3
           entry convs as z-slab convs, the faster form on them) and remat, in
           true float32: each of the seven
           layers at the input it gets in the full step (batch 2, (128,64,64),
           nf 20; found by hooks on a forward) in each form that takes it, y,
           dx and dW against F.conv3d and its autograd within 1e-4 of each one's
           largest entry, and device times (CUDA events) of the forward, the
           input gradient alone, the weight gradient alone and forward + both;
           the two 5^3 entry convs of the whole scene ((1,128,160,192)) forward
           only; one bfloat16 forward per form against F.conv3d in bfloat16 (the
           kernels' bf16 rule); the full step of train2d (its weights and
           batch) with each flag and with remat beside the default step, each
           trainer from the same state: launches per step (K1 33, K2 28, K3 23
           with either flag; with remat K1 38 and K3 46: every block's forward
           kernel once more in the backward), metrics within 1e-4 relative (2D
           and adversarial 1e-3) and the generator's gradients within 1e-2 of a
           leaf's largest entry of the default step's (train2d's twin rule),
           one warm-up and three timed steps (median seconds, peak memory) and
           device time by kind; the generator alone with and without remat on
           the card, and without it twice (outputs, running statistics and
           gradients identical to the bit or not); a gradient witness on three
           seeds (weights and batch), reported: the full step with the seven
           library convs in float64, the default step twice and the step with
           each flag, each one's generator gradients against the float64 step's
           per leaf (the worst leaves, the readings on the leaf that is worst
           between zslab_conv and the default) and the LeakyReLU slope flips of
           its forward against the float64 step's; the scene phase's whole
           scene with each flag: launches
           (K1 5, K3 23), seconds, peak, device time of the forward by kind,
           outputs within 1e-3 of the scene phase's
  parallel two ranks of a process group (spsg_tpu_torch/parallel/), each a
           process of its own started by this one (chip_smoke.py --parallel-rank):
           NCCL with a card a rank when the machine has two cards, else gloo
           with both ranks on the one card (printed; on one card these are
           correctness figures, not scaling figures). Each rank loads the
           kernels that the build phase built (rank 0 "builds" behind a
           barrier, finding them built). At full width: the full default step
           (train2d's) with mesh=, one framed chunk a rank of the global batch of
           2, against this process's step on the same batch and weights (metrics
           as train2d's twin, 1e-4 / 1e-3 relative; the generator's gradients
           within 1e-2 of each leaf's largest entry, the LeakyReLU slope flips of
           train2d's twin; the discriminator's within 1e-4), the ranks' metrics,
           gradients and parameters identical; the chunked scene of the path
           phase with mesh= (4 windows a rank of every batch of 8, rank 0
           stitches) against the path phase's scene, every field identical to
           the bit; the whole scene of the
           scene phase with mesh= (Y-slabs of 80 rows, halo exchanges) against
           the scene phase's outputs within 1e-4, rank 1's whole scene equal to
           rank 0's; the train CLI with --distributed (and --shared_card on one
           card) for 2 iterations of the full step: both ranks print their
           process line, only rank 0 writes, both end with the same parameters.
           Per part and rank: seconds (host clock, synchronised), peak memory,
           launches (counters set to 0 just before each part, read just after)
  kernels  one line {"kernels": [...]}: per kernel its launches on the
           paths (serve, scene, train, train2d, train2d_missing_colour,
           train2d_style, train2d_bf16, train_cli, datagen, parallel_train,
           parallel_chunked, parallel_scene (both ranks' counts added),
           train2d_zslab_conv, train2d_folded_conv, train2d_remat,
           scene_zslab_conv, scene_folded_conv;
           each counter set to 0 just before the path's run and read just
           after) and its numbers at the heaviest main-path shape (for the
           raycaster's, the prediction grid at the path's size; for K7 the
           mask with the most samples; for K8 the mean of 8 of the room scan's
           frames), with every shape (and, for the convs,
           both storage types) nested inside
  last     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Options (none when the script is run as the check of a checkout):
  --baseline-source PATH  another version of csrc/conv3x3.cu (e.g. the parent
           commit's, unpacked with git archive): built beside this one, and its
           K1 / K3 timed at every shape in turns with this one (baseline, this,
           this, baseline) through the same wrapper; "baseline_ms" per record
  --baseline-dw-source PATH  the same for csrc/conv3x3_dw.cu and K2
  --baseline-raycast-source PATH  the same for csrc/raycast.cu, K4, K5, K6 and
           K7 (a version with the C interface ops/raycast.py::_bind declares,
           K4-K6 run through the same wrappers; an older K7, which walks every
           sample, through its own entry spsg_raycast_occ, where the version
           has it), at the path's shape; "baseline_ms" per record
  --baseline-tsdf-source PATH  the same for csrc/tsdf.cu and K8 (a version
           with the whole-grid entry spsg_tsdf_integrate, from before the cull),
           on the room scan's frames; "baseline_ms" per frame

Tolerances. float32: |kernel - plain| <= 1e-4 on unit-variance outputs (both
accumulate in float32, in different orders; the forward kernel's 3xTF32
products are ~2^-20 relative); sums within rtol 1e-4. bfloat16:
both round the same float32 sum to bfloat16, so they differ only where the two
sums straddle a rounding boundary, by one step: <= 2e-2 for |y| < 4, and
2**-7 * |y| beyond; sums within rtol 1e-2. Weight gradient: within 1e-4
(float32) / 1e-2 (bfloat16 inputs: the plain version's product runs in another
precision) of the largest entry of dW; two runs bitwise equal. Backward of the
Functions, kernels against plain versions inside: dx, dW, db within 1e-4 of
their largest entry. Train step against the plain-conv twin: metrics within 1e-4
relative (also GPU against CPU at 16^3), each parameter gradient within 1e-2 of
its largest entry. The gradients' tolerance is not rounding of the backward: the
two forwards differ by float32 rounding (1e-5), which gives a few thousand of
the 1.5e9 activations, those within rounding of 0, the other LeakyReLU slope;
a weight gradient is a sum over N voxels of terms of either sign, of size
sqrt(N) terms, so k flipped terms move it by sqrt(k/N): 1e-3 to 2e-3 at the
(32,16,16) layers (N = 16384), where the largest differences are seen. Full
step against its twin, and GPU against CPU: the 3D metrics within 1e-4 relative,
the 2D and adversarial ones within 1e-3 (a prediction pixel whose hit flips
between two float32 forwards moves a mean over a few thousand pixels by ~1e-4);
against its twin also each parameter gradient of the generator within 1e-2 of
its largest entry, as in the train step; the discriminator's are reported only
(no hand kernel in its backward; they follow the render, whose rounding
differs between the two forwards); GPU against CPU: reported only. The
occupancy march: identical on every pixel (a select of bytes at positions the
kernel and its plain version round alike). The cached views against the step's
own: identical to the bit. The resumed epoch against the unbroken run: the
same iteration, epoch and Adam step counts; every parameter within 2 * lr per
step taken and >= 99.9 % of them within 1e-5 (ROADMAP.md Queue C's Adam rule:
K6's atomic adds and cuDNN's weight gradients are not bitwise repeatable, and
an element whose gradient is rounding noise moves by up to lr either way).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device",
          file=sys.stderr)
    sys.exit(2)

import torch.nn.functional as F  # noqa: E402

from spsg_tpu_torch.cli import test_scene_as_chunks as cli  # noqa: E402
from spsg_tpu_torch.datagen import fusion as tsdf  # noqa: E402
from spsg_tpu_torch.inference import chunked  # noqa: E402
from spsg_tpu_torch.losses import geo as geo_losses  # noqa: E402
from spsg_tpu_torch.models import convert  # noqa: E402
from spsg_tpu_torch.models.generator import ConvBlock, use_true_float32  # noqa: E402
from spsg_tpu_torch.ops import _build, conv3x3 as conv_ops  # noqa: E402
from spsg_tpu_torch.ops.folded_conv import conv_folded, pick_fold  # noqa: E402
from spsg_tpu_torch.ops.zslab_conv import conv3d_zslab  # noqa: E402
from spsg_tpu_torch.ops import depth as depth_ops, normals3d, raycast as rc_ops  # noqa: E402
from spsg_tpu_torch.training import StepFlags, TrainConfig  # noqa: E402
from spsg_tpu_torch.training import state  # noqa: E402
from spsg_tpu_torch.training.step import Trainer  # noqa: E402

DEV = torch.device("cuda:0")
T0 = time.time()

# NVIDIA H100 SXM data sheet, dense tensor-core rates and HBM3. float32 work is
# bounded as 3xTF32: three TF32 passes (hi*hi, hi*lo, lo*hi) are the least the
# card needs for a float32-accurate product, so its flops count three times
PEAK_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12}
PASSES = {torch.float32: 3, torch.bfloat16: 1}
BOUND_LABEL = {torch.float32: "3xTF32", torch.bfloat16: "bf16"}
PEAK_BYTES = 3.35e12

# name -> (source in this repo, TPU kernel it replaces)
KERNELS = {
    "conv3x3": ("spsg_tpu_torch/ops/csrc/conv3x3.cu", "spsg_tpu/ops/pallas_conv.py:127"),
    "conv3x3_act_stats": ("spsg_tpu_torch/ops/csrc/conv3x3.cu", "spsg_tpu/ops/pallas_conv.py:267"),
    "conv3x3_dw": ("spsg_tpu_torch/ops/csrc/conv3x3_dw.cu", "spsg_tpu/ops/pallas_conv.py:158"),
    # hand kernels for what the JAX package left to XLA (no Pallas kernel): the
    # functions of spsg_tpu/ops/raycast.py they stand for
    "raycast_march": ("spsg_tpu_torch/ops/csrc/raycast.cu", "spsg_tpu/ops/raycast.py:404"),
    "raycast_shade": ("spsg_tpu_torch/ops/csrc/raycast.cu", "spsg_tpu/ops/raycast.py:704"),
    "raycast_scatter": ("spsg_tpu_torch/ops/csrc/raycast.cu", "spsg_tpu/ops/raycast.py:739"),
    "raycast_occ": ("spsg_tpu_torch/ops/csrc/raycast.cu", "spsg_tpu/ops/raycast.py:878"),
    # the TSDF integrate of dataset generation (spsg_tpu/datagen/fusion.py, XLA)
    "tsdf_integrate": ("spsg_tpu_torch/ops/csrc/tsdf.cu", "spsg_tpu/datagen/fusion.py:77"),
}
CONV_KERNELS = ("conv3x3", "conv3x3_act_stats", "conv3x3_dw")
RAYCAST_KERNELS = ("raycast_march", "raycast_shade", "raycast_scatter", "raycast_occ")
# (B, Z, Y, X, Cin, Cout, on the main path?)
TOY = (2, 4, 8, 8, 5, 6, False)
SHAPES = [
    TOY,
    (1, 128, 64, 64, 20, 20, True),
    (1, 128, 64, 64, 100, 40, True),   # decoder_3a, the heaviest layer
    (1, 128, 64, 64, 10, 1, True),
    (1, 128, 64, 64, 20, 14, True),
    (1, 32, 16, 16, 100, 100, True),
    (1, 128, 64, 64, 40, 40, True),    # decoder_3b, the second heaviest
    (1, 128, 64, 64, 40, 20, True),    # decoder_3c
    (1, 128, 64, 64, 25, 20, True),    # color_head_a, semantic_head_a
    (1, 64, 32, 32, 100, 40, True),    # decoder_2a
    (1, 64, 32, 32, 40, 40, True),     # decoder_2b, _2c, encoder_0c
    (8, 32, 16, 16, 100, 100, True),   # encoder_1b, _1c at the serving window batch
    (2, 32, 16, 16, 100, 100, True),   # ... and at the training batch
    (1, 6, 12, 20, 7, 130, False),     # edges: ragged tiles in X and Y, Cin and Cout of
                                       # 4-byte copies, Cout > 104 (N over two blocks)
]
HEAVIEST = SHAPES[2]
# what the backward gives the forward kernel (dx = conv of the cotangent with
# flipped weights, Cin and Cout swapped): decoder_3a, semantic_head_c,
# geo_occ_b / geo_3c, and color_head_c (on the path once the 2D colour losses
# are ported: the 3D losses do not reach the colour head)
DX_SHAPES = [
    (1, 128, 64, 64, 40, 100, True),
    (1, 128, 64, 64, 14, 20, True),
    (1, 128, 64, 64, 1, 10, True),
    (1, 128, 64, 64, 3, 10, False),
]
# the weight gradient alone at the training batch's heaviest layer (x: 420 MB)
DW_SHAPES = [(2, 128, 64, 64, 100, 40, True)]
# K1 and K3 at the whole-scene path's shapes (the test_scene CLI): decoder_3a and a
# 20->20 layer over the (128,160,192) scene, and decoder_3a at the reference's
# default bound (128,260,328), whose input passes 2^32 bytes
SCENE_SHAPES = [
    (1, 128, 160, 192, 100, 40, True),
    (1, 128, 160, 192, 20, 20, True),
    (1, 128, 260, 328, 100, 40, True),
]
FULL_3D = dict(pred_sdf=True, pred_color=True, pred_semantic=True)
# libraries of other versions of the kernels' sources (--baseline-source,
# --baseline-dw-source, --baseline-raycast-source), by source name
BASELINE = {}
GEO_ONLY = dict(pred_sdf=True, pred_color=False, pred_semantic=False)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 1), **kw}), flush=True)


def all_launch_counts():
    return {**conv_ops.launch_counts, **rc_ops.launch_counts, **tsdf.launch_counts}


def reset_all_launch_counts():
    conv_ops.reset_launch_counts()
    rc_ops.reset_launch_counts()
    tsdf.reset_launch_counts()


def cuda_ms(fn, reps):
    fn()  # warm up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# --------------------------------------------------------------------------- device
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


# --------------------------------------------------------------------------- build
def phase_build():
    t = time.time()
    _build.build_all()
    seconds = time.time() - t
    info = _build.BUILD_INFO
    sources = {}
    for n in _build.SOURCES:
        hmma = _build.sass_summary(n)
        kernels = _build.ptxas_summary(n)
        for k in kernels:
            k["hmma"] = hmma.get(k["kernel"], "not found") if "error" not in hmma else "not measured"
        sources[n] = dict(seconds=round(info[n]["seconds"], 2), cached=info[n]["cached"],
                          library=os.path.relpath(info[n]["path"]), ptxas=kernels,
                          sass_error=hmma.get("error"))
        if "error" not in hmma and n in CONV_KERNELS:
            # the forward and the weight-gradient kernels run on the tensor cores in
            # every variant
            kern = f"{n}_kernel"
            conv = {k: v for k, v in hmma.items() if kern in k}
            if not conv or not all(v > 0 for v in conv.values()):
                raise SystemExit(f"chip_smoke: {kern} variants without HMMA: "
                                 f"{[k for k, v in conv.items() if not v > 0] or 'none built'}")
    emit("build", seconds=round(seconds, 2), nvcc_flags=" ".join(_build.NVCC_FLAGS),
         sources=sources)


def load_baseline(src, key):
    """The library of another version of csrc/<key>.cu, built with the same
    flags and bound like the package's own."""
    t = time.time()
    bind = {"conv3x3": conv_ops._bind_conv, "conv3x3_dw": conv_ops._bind_dw,
            "raycast": rc_ops._bind, "tsdf": bind_tsdf_baseline}[key]
    lib = bind(ctypes.CDLL(_build.build_source(src, f"{key}_baseline", key)))
    emit("baseline", kernel=key, source=src, seconds=round(time.time() - t, 2))
    return lib


def time_kernel(fn, reps, rec, key="conv3x3"):
    """rec["ms"] of a call of the kernel of library ``key``; with a baseline
    of that library also rec["baseline_ms"], taken in turns (baseline, this,
    this, baseline) through the same wrapper."""
    if key not in BASELINE:
        rec["ms"] = cuda_ms(fn, reps)
        return

    def on_baseline():  # fn has run once already, so the package's library is loaded
        saved = conv_ops._libs[key]
        conv_ops._libs[key] = BASELINE[key]
        try:
            return cuda_ms(fn, reps)
        finally:
            conv_ops._libs[key] = saved

    turns = [on_baseline(), cuda_ms(fn, reps), cuda_ms(fn, reps), on_baseline()]
    rec.update(ms=(turns[1] + turns[2]) / 2, baseline_ms=(turns[0] + turns[3]) / 2,
               ms_turns=turns)


# --------------------------------------------------------------------------- compare
def bound(shape, dtype, weight_dtype=None):
    """Least time for a conv of this shape (forward, dx or dW: the same flops,
    the two volumes and the weights each moved once; float32 operations at
    three TF32 passes); dW is float32. Returns (ms, what bounds it, flops)."""
    B, Z, Y, X, Ci, Co = shape[:6]
    vox = B * Z * Y * X
    flops = 2.0 * 27 * Ci * Co * vox
    esize = torch.empty((), dtype=dtype).element_size()
    wsize = esize if weight_dtype is None else torch.empty((), dtype=weight_dtype).element_size()
    nbytes = vox * (Ci + Co) * esize + 27 * Ci * Co * wsize
    t_ops = PASSES[dtype] * flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def check_y(y, ref, dtype, what):
    err = (y.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-4).all())
    else:
        ok = bool((err <= torch.clamp(ref.float().abs() * 2.0 ** -7, min=2e-2)).all())
    if not ok or not torch.isfinite(y.float()).all():
        raise SystemExit(f"chip_smoke: {what}: kernel and plain version disagree "
                         f"(max abs err {err.max().item():.3e})")
    return err.max().item()


def compare_one(shape, dtype, gen, forward_only=False, dw=True):
    """Kernels against plain versions at one shape: all three, with
    ``forward_only`` conv3x3 alone, without ``dw`` the two forward kernels.
    Returns {kernel name: record}."""
    B, Z, Y, X, Ci, Co, on_path = shape
    x = torch.randn(B, Z, Y, X, Ci, generator=gen).to(dtype).to(DEV)
    w = (torch.randn(3, 3, 3, Ci, Co, generator=gen) / (27 * Ci) ** 0.5).to(dtype).to(DEV)
    b = (0.1 * torch.randn(Co, generator=gen)).to(DEV)
    big = B * Z * Y * X * Ci * Co > 1e7
    reps, plain_reps = (10, 2) if big else (50, 5)
    bound_ms, bound_by, flops = bound(shape, dtype)
    tag = f"{tuple(shape[:4])} {Ci}->{Co} {str(dtype).split('.')[1]}"
    xc = x.permute(0, 4, 1, 2, 3)                    # (B,C,Z,Y,X) view, same memory
    wc = w.permute(4, 3, 0, 1, 2).contiguous()       # (O,I,3,3,3)
    out = {}

    # conv3x3
    y = conv_ops.conv3x3(x, w)
    torch.cuda.synchronize()
    ref = conv_ops.conv3x3_plain(x, w)
    rec = dict(shape=list(shape[:4]), cin=Ci, cout=Co, main_path=on_path,
               max_abs_err=check_y(y, ref, dtype, f"conv3x3 {tag}"))
    time_kernel(lambda: conv_ops.conv3x3(x, w), reps, rec)
    rec["plain_ms"] = cuda_ms(lambda: conv_ops.conv3x3_plain(x, w), plain_reps)
    rec["library_ms"] = cuda_ms(lambda: F.conv3d(xc, wc, padding=1), reps)
    rec.update(bound_ms=bound_ms, bound_by=bound_by, bound_rate=BOUND_LABEL[dtype],
               tflops=flops / rec["ms"] / 1e9, eff=bound_ms / rec["ms"])
    out["conv3x3"] = rec
    del y, ref
    if forward_only:
        return out

    # conv3x3_act_stats
    y, s, ss = conv_ops.conv3x3_act_stats(x, w, b)
    torch.cuda.synchronize()
    ry, rs, rss = conv_ops.conv3x3_act_stats_plain(x, w, b)
    rec = dict(shape=list(shape[:4]), cin=Ci, cout=Co, main_path=on_path,
               max_abs_err=check_y(y, ry, dtype, f"conv3x3_act_stats {tag}"))
    rtol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want, name in ((s, rs, "sum"), (ss, rss, "sumsq")):
        rel = ((got - want).abs() / want.abs()).max().item()
        if not rel <= rtol:
            raise SystemExit(f"chip_smoke: conv3x3_act_stats {tag}: {name} off by rel {rel:.3e}")
        rec[f"{name}_max_rel_err"] = rel
    y2, s2, ss2 = conv_ops.conv3x3_act_stats(x, w, b)
    rec["repeats_bitwise"] = bool(torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(ss, ss2))
    if not rec["repeats_bitwise"]:
        raise SystemExit(f"chip_smoke: conv3x3_act_stats {tag}: two runs differ")
    del y, s, ss, ry, rs, rss, y2, s2, ss2

    def library():
        v = F.leaky_relu(F.conv3d(xc, wc, b.to(dtype), padding=1), 0.2)
        vf = v.float()
        return v, vf.sum((0, 2, 3, 4)), (vf * vf).sum((0, 2, 3, 4))

    time_kernel(lambda: conv_ops.conv3x3_act_stats(x, w, b), reps, rec)
    rec["plain_ms"] = cuda_ms(lambda: conv_ops.conv3x3_act_stats_plain(x, w, b), plain_reps)
    rec["library_ms"] = cuda_ms(library, reps)
    rec.update(bound_ms=bound_ms, bound_by=bound_by, bound_rate=BOUND_LABEL[dtype],
               tflops=flops / rec["ms"] / 1e9, eff=bound_ms / rec["ms"])
    out["conv3x3_act_stats"] = rec
    if dw:
        out["conv3x3_dw"] = compare_dw(shape, dtype, gen, x, xc, reps, plain_reps, tag)
    return out


def compare_dw(shape, dtype, gen, x, xc, reps, plain_reps, tag):
    """conv3x3_dw against conv3x3_dw_plain on ``x`` (a (B,C,Z,Y,X) view of it
    in ``xc``) and a random cotangent."""
    B, Z, Y, X, Ci, Co, on_path = shape
    dy = torch.randn(B, Z, Y, X, Co, generator=gen).to(dtype).to(DEV)
    dyc = dy.permute(0, 4, 1, 2, 3)
    dw = conv_ops.conv3x3_dw(x, dy)
    torch.cuda.synchronize()
    ref = conv_ops.conv3x3_dw_plain(x, dy)
    rel = ((dw - ref).abs().max() / ref.abs().max()).item()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    if not (rel <= tol and dw.dtype == torch.float32 and torch.isfinite(dw).all()):
        raise SystemExit(f"chip_smoke: conv3x3_dw {tag}: kernel and plain version disagree "
                         f"(max err {rel:.3e} of max|dW|)")
    again = conv_ops.conv3x3_dw(x, dy)
    if not torch.equal(dw, again):
        raise SystemExit(f"chip_smoke: conv3x3_dw {tag}: two runs differ")
    bound_ms, bound_by, flops = bound(shape, dtype, weight_dtype=torch.float32)
    rec = dict(shape=list(shape[:4]), cin=Ci, cout=Co, main_path=on_path,
               max_abs_err=(dw - ref).abs().max().item(), max_rel_err=rel, repeats_bitwise=True)
    del dw, ref, again
    time_kernel(lambda: conv_ops.conv3x3_dw(x, dy), reps, rec, key="conv3x3_dw")
    rec["plain_ms"] = cuda_ms(lambda: conv_ops.conv3x3_dw_plain(x, dy), plain_reps)
    rec["library_ms"] = cuda_ms(
        lambda: torch.nn.grad.conv3d_weight(xc, (Co, Ci, 3, 3, 3), dyc, padding=1), reps)
    rec.update(bound_ms=bound_ms, bound_by=bound_by, bound_rate=BOUND_LABEL[dtype],
               tflops=flops / rec["ms"] / 1e9, eff=bound_ms / rec["ms"])
    return rec


def compare_dw_alone(shape, dtype, gen):
    """conv3x3_dw at a shape where only the weight gradient is compared."""
    B, Z, Y, X, Ci, Co, _ = shape
    x = torch.randn(B, Z, Y, X, Ci, generator=gen).to(dtype).to(DEV)
    tag = f"{tuple(shape[:4])} {Ci}->{Co} {str(dtype).split('.')[1]}"
    return compare_dw(shape, dtype, gen, x, x.permute(0, 4, 1, 2, 3), 5, 1, tag)


@contextlib.contextmanager
def plain_versions_inside():
    """Inside, the autograd Functions of ops/conv3x3.py take the plain versions
    on CUDA tensors too: the same backward algebra without the kernels."""
    saved = (conv_ops._conv, conv_ops._conv_act_stats, conv_ops.conv3x3_dw)
    conv_ops._conv = conv_ops.conv3x3_plain
    conv_ops._conv_act_stats = conv_ops.conv3x3_act_stats_plain
    conv_ops.conv3x3_dw = conv_ops.conv3x3_dw_plain
    try:
        yield
    finally:
        conv_ops._conv, conv_ops._conv_act_stats, conv_ops.conv3x3_dw = saved


def compare_backward(shape, gen):
    """Full backward of both Functions at ``shape``: kernels against the plain
    versions inside the same Functions, on the same graph, with all three
    cotangents of the fused function non-zero. Returns max errors relative to
    the largest entry of each gradient, and the device time of the
    dy_total -> dconv -> db pass, which is plain PyTorch in this version."""
    B, Z, Y, X, Ci, Co, _ = shape
    x = torch.randn(B, Z, Y, X, Ci, generator=gen).to(DEV).requires_grad_()
    w = (torch.randn(3, 3, 3, Ci, Co, generator=gen) / (27 * Ci) ** 0.5).to(DEV).requires_grad_()
    b = (0.1 * torch.randn(Co, generator=gen)).to(DEV).requires_grad_()
    cts = (torch.randn(B, Z, Y, X, Co, generator=gen).to(DEV),
           (0.1 * torch.randn(Co, generator=gen)).to(DEV),
           (0.01 * torch.randn(Co, generator=gen)).to(DEV))
    rec = {}
    for name, fn, leaves, ct in (
            ("conv3x3", conv_ops.conv3x3, (x, w), cts[0]),
            ("conv3x3_act_stats", conv_ops.conv3x3_act_stats, (x, w, b), cts)):
        # one forward (with the kernel), two backwards over the same graph: the
        # slope of the LeakyReLU is read from the saved activation, and a forward
        # of the plain version would differ in sign at the few voxels within
        # rounding of 0 (the forward is compared on its own, above)
        conv_ops.reset_launch_counts()
        outs = fn(*leaves)
        got = torch.autograd.grad(outs, leaves, ct, retain_graph=True)
        launched = dict(conv_ops.launch_counts)
        with plain_versions_inside():
            ref = torch.autograd.grad(outs, leaves, ct)
        del outs
        want = {"conv3x3": 1 + (name == "conv3x3"), "conv3x3_act_stats": int(name != "conv3x3"),
                "conv3x3_dw": 1}
        if launched != want or sum(conv_ops.launch_counts.values()) != sum(want.values()):
            raise SystemExit(f"chip_smoke: backward of {name}: launches {launched}, expected {want}")
        errs = {}
        for g, r, leaf in zip(got, ref, ("dx", "dw", "db")):
            errs[leaf] = ((g - r).abs().max() / r.abs().max()).item()
            if not errs[leaf] <= 1e-4:
                raise SystemExit(f"chip_smoke: backward of {name}: {leaf} differs from the "
                                 f"plain versions by {errs[leaf]:.3e} of its largest entry")
        rec[name] = errs
        del got, ref
    y = conv_ops.conv3x3_act_stats(x.detach(), w.detach(), b.detach())[0]

    def elementwise():
        dy_total = cts[0].float() + cts[1] + 2.0 * y.float() * cts[2]
        dconv = torch.where(y > 0, dy_total, 0.2 * dy_total).to(y.dtype)
        return dconv, dconv.float().sum(dim=(0, 1, 2, 3))

    rec["act_stats_backward_elementwise_ms"] = cuda_ms(elementwise, 5)
    return rec


def phase_compare():
    use_true_float32()
    gen = torch.Generator().manual_seed(0)
    results = {k: {"float32": [], "bfloat16": []} for k in CONV_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SHAPES:
            for name, rec in compare_one(shape, dtype, gen).items():
                results[name][str(dtype).split(".")[1]].append(rec)
            torch.cuda.empty_cache()
        for shape in SCENE_SHAPES:
            for name, rec in compare_one(shape, dtype, gen, dw=False).items():
                results[name][str(dtype).split(".")[1]].append(dict(rec, path="scene"))
            torch.cuda.empty_cache()
        for shape in DX_SHAPES:
            rec = compare_one(shape, dtype, gen, forward_only=True)["conv3x3"]
            results["conv3x3"][str(dtype).split(".")[1]].append(dict(rec, role="dx"))
            torch.cuda.empty_cache()
        for shape in DW_SHAPES:
            results["conv3x3_dw"][str(dtype).split(".")[1]].append(
                compare_dw_alone(shape, dtype, gen))
            torch.cuda.empty_cache()
    backward = compare_backward(HEAVIEST, gen)
    torch.cuda.empty_cache()
    # the per-shape numbers go into the "kernels" line at the end
    emit("compare", tolerance={"float32": "abs 1e-4, sums rtol 1e-4, dW 1e-4 of max|dW|",
                               "bfloat16": "abs max(2e-2, 2**-7*|y|), sums rtol 1e-2, "
                                           "dW 1e-2 of max|dW|",
                               "backward": "dx, dW, db 1e-4 of their largest entry"},
         backward_kernels_vs_plain_inside=backward,
         cases=sum(len(v) for r in results.values() for v in r.values()),
         max_abs_err={name: {dt: max(c["max_abs_err"] for c in recs) for dt, recs in r.items()}
                      for name, r in results.items()})
    return results


# --------------------------------------------------------------------------- compare: raycaster
# (dims (Z,Y,X), image (W,H)): a toy size, and the training path's
RC_SHAPES = [((16, 16, 16), (48, 32), False), ((128, 64, 64), (320, 256), True)]
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# arithmetic of one march sample: position (3 mul + 3 add), floor and weights
# (3 floor, 3 sub, 3 sub, 16 mul), the trilinear sum (8 mul + 7 add), the test
TRILERP_FLOPS = 50
def on_raycast_library(fn, lib):
    """``fn`` run with the raycaster's wrappers on another build ``lib`` of
    raycast.cu (its C interface the one ops/raycast.py::_bind declares)."""
    def run():
        rc_ops._library()  # the package's own, loaded before it is swapped out
        saved = rc_ops._libs["raycast"]
        rc_ops._libs["raycast"] = lib
        try:
            return fn()
        finally:
            rc_ops._libs["raycast"] = saved
    return run


def device_ms(fn, reps):
    """Device time of one call of ``fn`` (launches only, no host read): the
    calls are queued behind a spin of the card that outlasts their host time,
    so the events time the kernels back to back, not the wrapper's launches
    (a raycaster wrapper can take longer on the host than its kernels)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host * 2e9) + 10 ** 6)  # cycles, at about 2 GHz
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_split_ms(fn, reps=5):
    """Device time of each kernel of one call of ``fn``, by name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (re.search(r"(\w+)\(", e.key) for e in prof.key_averages())
    return {m.group(1) if m else e.key[:60]: e.self_device_time_total / reps / 1e3
            for m, e in zip(names, prof.key_averages()) if e.self_device_time_total > 0}


def time_in_turns(fn, baseline, reps, rec):
    """rec["ms"] of ``fn``; with a ``baseline`` also rec["baseline_ms"], the
    two in turns (baseline, fn, fn, baseline), as time_kernel does."""
    if baseline is None:
        rec["ms"] = device_ms(fn, reps)
        return
    turns = [device_ms(baseline, reps), device_ms(fn, reps), device_ms(fn, reps),
             device_ms(baseline, reps)]
    rec.update(ms=(turns[1] + turns[2]) / 2, baseline_ms=(turns[0] + turns[3]) / 2,
               ms_turns=turns)


def to_dev(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)


def raycast_grids(dims, image, seed):
    """The step's three grids of a make_chunk_batch with frames (rendered on
    the card): the input, the target and a prediction made of the target plus
    noise (N(0, 0.5) voxels), each with its valid voxels, and the cameras."""
    from spsg_tpu_torch.data import synthetic

    b = synthetic.make_chunk_batch(2, dims, image, seed=seed, with_frames=True, device=DEV)
    tgt = np.clip(b["target_sdf"], -3.0, 3.0)
    noise = np.random.default_rng(seed).normal(0, 0.5, tgt.shape).astype(np.float32)
    grids = {"input": b["input"][..., 0], "target": tgt, "prediction": tgt + noise}
    return ({k: (to_dev(g), to_dev(np.abs(g) < 3.0)) for k, g in grids.items()},
            to_dev(b["images_view"]), to_dev(b["images_intrinsic"]))


def march_diffs(got, ref):
    """Pixels where two marches differ: hit, hit_idx, and alpha and depth to
    the bit."""
    bits = (lambda a, b: int((a.view(torch.int32) != b.view(torch.int32)).sum()))
    return dict(hit_diff=int((got[0] != ref[0]).sum()), hit_idx_diff=int((got[3] != ref[3]).sum()),
                alpha_bits_diff=bits(got[1], ref[1]), depth_bits_diff=bits(got[2], ref[2]))


def compare_march(sdf, valid, view, intr, cfg, tag, on_path):
    """K4 against march_plain on the same ray set-up: hit, hit_idx, alpha and
    depth identical to the bit on every pixel; the kernel's count of its work
    (lattice index at exit, samples that loaded corners) equal to
    march_work_plain's. The bound counts what any march of this lattice must
    do: the lattice samples up to each ray's exit whose cell is fully valid
    (march_work_plain, not the kernel) and the bisections, at TRILERP_FLOPS
    each; bound_ms_every_sample counts every lattice sample up to the exit."""
    setup = rc_ops.march_setup(valid, view, intr, cfg)
    B, n_vox = sdf.shape[0], sdf[0].numel()
    P = setup.t0.shape[1]
    n_px = B * P
    samples = torch.empty((B, P), dtype=torch.int32, device=DEV)
    evaluated = torch.empty_like(samples)
    got = rc_ops.march(sdf, valid, setup, cfg, samples=samples, evaluated=evaluated)
    torch.cuda.synchronize()
    ref = rc_ops.march_plain(sdf, valid, setup, cfg)
    diffs = march_diffs(got, ref)
    if any(diffs.values()):
        raise SystemExit(f"chip_smoke: raycast_march {tag}: kernel and plain version differ "
                         f"on {diffs} of {n_px} pixels")
    work = rc_ops.march_work_plain(sdf, valid, setup, cfg)
    if not (torch.equal(samples.long(), work["samples"])
            and torch.equal(evaluated.long(), work["fully_valid"])):
        raise SystemExit(f"chip_smoke: raycast_march {tag}: the kernel's count of its work "
                         f"differs from march_work_plain's")
    bis = cfg.bisection_iters * n_px
    lattice, needed = int(work["samples"].sum()), int(work["fully_valid"].sum())
    # sdf and valid once, the rays' set-up (origin per batch row; direction,
    # cam_z, t0, t_stop per ray) and the four outputs
    nbytes = B * n_vox * 5 + B * 12 + n_px * (12 + 12) + n_px * 13
    t_bytes = nbytes / PEAK_BYTES
    t_ops = (needed + bis) * TRILERP_FLOPS / F32_FLOPS
    t_ops_every = (lattice + bis) * TRILERP_FLOPS / F32_FLOPS
    rec = dict(hits=int(got[0].sum()), **diffs, max_abs_err=0.0,
               lattice_samples=lattice + bis, samples_per_ray=(lattice + bis) / n_px,
               evaluated_per_ray=(int(evaluated.sum()) + bis) / n_px,
               in_blocks_per_ray=(int(work["in_blocks"].sum()) + bis) / n_px,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_ms_every_sample=max(t_bytes, t_ops_every) * 1e3,
               plain_ms=cuda_ms(lambda: rc_ops.march_plain(sdf, valid, setup, cfg), 2),
               library_ms=None)
    fn = (lambda: rc_ops.march(sdf, valid, setup, cfg))
    baseline = None
    if "raycast" in BASELINE:
        rec["baseline_diffs"] = march_diffs(on_raycast_library(fn, BASELINE["raycast"])(), ref)
        if on_path:
            baseline = on_raycast_library(fn, BASELINE["raycast"])
    time_in_turns(fn, baseline, 20, rec)
    if on_path:
        rec["kernels_ms"] = kernel_split_ms(fn)
    return rec, got


def compare_scatter(cts, hit, hit_idx, n_vox, tag, on_path):
    """K6 against scatter_plain: within 1e-5 of each output's largest entry
    (float32 sums of the same terms, the kernel's atomic adds in another
    order), all finite; times beside the baseline's and one index_add_ +
    divide on the same inputs."""
    B, P = hit.shape
    got = rc_ops.scatter(*cts, hit, hit_idx, n_vox)
    torch.cuda.synchronize()
    ref = rc_ops.scatter_plain(*cts, hit, hit_idx, n_vox)

    errs = [float((g - r).abs().max() / r.abs().max().clamp(min=1e-30)) for g, r in zip(got, ref)]
    if not (max(errs) <= 1e-5 and all(torch.isfinite(g).all() for g in got)):
        raise SystemExit(f"chip_smoke: raycast_scatter {tag}: kernel and plain version differ "
                         f"by {errs} of their largest entries")
    rows = torch.arange(B, device=DEV)[:, None]
    G = torch.cat([c.reshape(B, P, -1) for c in (cts[0], cts[1], cts[2], cts[3][..., None])]
                  + [torch.ones(B, P, 1, device=DEV)], dim=-1)
    G = torch.where(hit[..., None] & torch.isfinite(G), G, 0.0).reshape(-1, 22)
    flat_rows = (rows * (n_vox + 1) + torch.where(hit, hit_idx.long(), n_vox)).reshape(-1)

    def library():
        acc = torch.zeros(B * (n_vox + 1), 22, device=DEV).index_add_(0, flat_rows, G)
        return acc[:, :-1] / acc[:, -1:].clamp(min=1.0)

    # cotangents and hit / hit_idx read once, the four gradients written once
    nbytes = B * P * (84 + 5) + B * n_vox * 84
    rec = dict(hits=int(hit.sum()), voxels_hit=int(torch.unique(
        (rows * n_vox + hit_idx.long())[hit]).numel()), max_rel_err=max(errs),
        max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got, ref)),
        bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
        plain_ms=cuda_ms(lambda: rc_ops.scatter_plain(*cts, hit, hit_idx, n_vox), 5),
        library_ms=device_ms(library, 20))
    fn = (lambda: rc_ops.scatter(*cts, hit, hit_idx, n_vox))
    baseline = (on_raycast_library(fn, BASELINE["raycast"])
                if "raycast" in BASELINE and on_path else None)
    time_in_turns(fn, baseline, 20, rec)
    if on_path:
        rec["kernels_ms"] = kernel_split_ms(fn)
    return rec


def bits_equal(got, ref):
    """Outputs equal to the bit (a NaN counts only if its bits are the same)."""
    return all(torch.equal(g.view(torch.int32), r.view(torch.int32)) for g, r in zip(got, ref))


def shade_cases(hit, hit_idx, depth, n_vox, gen):
    """Random attributes (colour, normal with some exactly zero, semantic) and
    K5's cases, name -> (color, normal, semantic, hit, hit_idx, depth): the
    march's hits, and the edge cases: a ragged pixel count (the first 997
    pixels of each row, made contiguous: B * 997 is no multiple of a block's
    pixels), the training step's input grid (semantic None), every attribute
    None, NaN (one with a sign and a payload) and +-inf attributes, a row
    without a hit and a row of hits."""
    B = hit.shape[0]
    attrs = [torch.randn(B, n_vox, c, generator=gen).to(DEV) for c in (3, 3, 14)]
    attrs[1][:, ::7] = 0.0  # voxels with a zero normal
    odd = [a.clone() for a in attrs]
    odd[0][:, 2::3, 0] = float("nan")
    odd[0][:, 1::4, 2] = -float("inf")
    odd[1][:, 3::9] = float("nan")  # a NaN normal is not zero
    odd[1][:, 5::11, 1] = float("inf")
    odd[2][:, ::4, 5] = torch.tensor([-0x3FFFFF], dtype=torch.int32).view(torch.float32).to(DEV)
    odd[2][:, 1::6, 13] = float("inf")
    rows = hit.clone()
    rows[0] = False
    rows[-1] = True
    cut = [a[:, :997].contiguous() for a in (hit, hit_idx, depth)]
    return attrs, {"hits": (*attrs, hit, hit_idx, depth),
                   "ragged_997": (*attrs, *cut),
                   "step_input_grid": (attrs[0], attrs[1], None, hit, hit_idx, depth),
                   "all_absent": (None, None, None, hit, hit_idx, depth),
                   "non_finite": (*odd, hit, hit_idx, depth),
                   "row_without_hit_row_of_hits": (*attrs, rows, hit_idx, depth)}


def shade_bound_ms(hit, hit_idx, attrs, per_pixel=False):
    """hit, hit_idx, depth a pixel read once, the rows of the present
    attributes of each voxel hit read once (per_pixel: once for each pixel
    that hits it, the earlier count), 21 floats a pixel written once."""
    B, P = hit.shape
    row = sum(4 * a.shape[-1] for a in attrs if a is not None)
    voxel = torch.arange(B, device=hit.device)[:, None] * 2 ** 32 + hit_idx.long()
    rows = int(hit.sum()) if per_pixel else torch.unique(voxel[hit]).numel()
    return (B * P * 9 + rows * row + B * P * 84) / PEAK_BYTES * 1e3


def compare_shade_scatter(hits, n_vox, gen, tag, on_path):
    """K5 against shade_plain (identical to the bit, also on its edge cases)
    and K6 against scatter_plain, on random attributes and cotangents, some of
    them not finite: once on the march's hits, and once with every hit pixel
    remapped onto 8 neighbouring voxels (contention: thousands of pixels a
    voxel). K5 is timed as the prediction's render calls it and as the input
    grid's does (semantic None)."""
    hit, _, depth, hit_idx = hits
    B, P = hit.shape
    attrs, cases = shade_cases(hit, hit_idx, depth, n_vox, gen)
    for name, args in cases.items():
        got = rc_ops.shade(*args)
        torch.cuda.synchronize()
        if not bits_equal(got, rc_ops.shade_plain(*args)):
            raise SystemExit(f"chip_smoke: raycast_shade {tag}, {name}: kernel and plain "
                             f"version differ")
    table = torch.cat(attrs, dim=-1)
    rows = torch.arange(B, device=DEV)[:, None]
    shade_rec = dict(
        hits=int(hit.sum()), identical=sorted(cases), max_abs_err=0.0,
        bound_ms=shade_bound_ms(hit, hit_idx, attrs), bound_by="bytes",
        bound_ms_row_per_pixel=shade_bound_ms(hit, hit_idx, attrs, per_pixel=True),
        plain_ms=cuda_ms(lambda: rc_ops.shade_plain(*attrs, hit, hit_idx, depth), 10),
        # the gather alone, one advanced-indexing call on the packed attributes
        library_ms=device_ms(lambda: table[rows, hit_idx.long()], 50))
    shade_rec["step_input_grid"] = dict(bound_ms=shade_bound_ms(hit, hit_idx, attrs[:2]))
    for rec, args in ((shade_rec, cases["hits"]),
                      (shade_rec["step_input_grid"], cases["step_input_grid"])):
        fn = (lambda args=args: rc_ops.shade(*args))
        baseline = (on_raycast_library(fn, BASELINE["raycast"])
                    if "raycast" in BASELINE and on_path else None)
        time_in_turns(fn, baseline, 50, rec)

    cts = [torch.randn(B, P, c, generator=gen).to(DEV) for c in (3, 3, 14)]
    cts.append(torch.randn(B, P, generator=gen).to(DEV))
    cts[0][:, ::11, 0] = float("nan")
    cts[2][:, ::13, 3] = float("inf")
    scatter_rec = compare_scatter(cts, hit, hit_idx, n_vox, tag, on_path)
    crowded = (n_vox // 2 + torch.arange(P, device=DEV) % 8).to(torch.int32).expand(B, P)
    scatter_rec["contention"] = compare_scatter(cts, hit, crowded.contiguous(), n_vox,
                                                f"{tag}, 8 voxels", on_path)
    return shade_rec, scatter_rec


# float32 operations of one sample of the occupancy march: t (convert, mul,
# add), the position (3 mul, 3 add), + 0.5 (3 add), floor (3), the bounds (6)
OCC_SAMPLE_FLOPS = 20
# the grids of K7 whose work the "kernels" line reports (the step's masks and
# the empty grid; the adversarial grids check the skip)
OCC_STEP_GRIDS = ("missing", "target_band", "empty")


def baseline_occ_march(lib, occ, setup, cfg, samples=None):
    """K7 of an older raycast.cu (``spsg_raycast_occ``: every lattice sample
    walked, no map) on the same rays: (B,P) uint8."""
    B, Z, Y, X = occ.shape
    P = setup.t0.shape[1]
    hit = torch.empty((B, P), dtype=torch.uint8, device=DEV)
    err = lib.spsg_raycast_occ(
        occ.data_ptr(), setup.origin.data_ptr(), setup.direction.data_ptr(),
        setup.t0.data_ptr(), setup.t_stop.data_ptr(), hit.data_ptr(),
        None if samples is None else samples.data_ptr(), B, Z, Y, X, P, cfg.width,
        cfg.ray_increment, cfg.max_samples, torch.cuda.current_stream(DEV).cuda_stream)
    if err:
        raise SystemExit(f"chip_smoke: the baseline's raycast_occ failed with error {err}")
    return hit


def compare_occ(occ, setup, cfg, tag, on_path, camera=None):
    """K7 against occ_march_plain on the same rays: identical on every pixel,
    and the kernel's lattice index at exit per ray equal to the plain
    version's; its count of loaded samples and the pre-pass's map equal to
    occ_march_work_plain's and occ_skip_map_plain's (so the kernel hopped as
    designed). The bound: the grid read once (a byte a voxel), the rays'
    set-up and the image; or, at OCC_SAMPLE_FLOPS float32 operations each,
    the samples up to each ray's exit whose (undilated) 8^3 block holds an
    occupied voxel (occ_march_work_plain's in_blocks); beside it the earlier
    bound, every sample to the exit. ``camera`` (view, intrinsics): the rays came
    from raycast_occ's set-up, whose host syncs and time are measured too."""
    B, n_vox = occ.shape[0], occ[0].numel()
    P = setup.t0.shape[1]
    n_px = B * P
    samples = torch.empty((B, P), dtype=torch.int32, device=DEV)
    evaluated = torch.empty_like(samples)
    block_map = torch.empty(rc_ops.occ_skip_map_shape(occ.shape), dtype=torch.uint8, device=DEV)
    got = rc_ops.occ_march(occ, setup, cfg, samples=samples, evaluated=evaluated,
                           block_map=block_map)
    torch.cuda.synchronize()
    ref, ref_samples = rc_ops.occ_march_plain(occ, setup, cfg, return_samples=True)
    work = rc_ops.occ_march_work_plain(occ, setup, cfg)
    diff = int((got != ref).sum())
    checks = dict(samples=torch.equal(samples.long(), ref_samples),
                  evaluated=torch.equal(evaluated.long(), work["evaluated"]),
                  block_map=torch.equal(block_map.bool(), rc_ops.occ_skip_map_plain(occ)))
    if diff or not all(checks.values()):
        raise SystemExit(f"chip_smoke: raycast_occ {tag}: kernel and plain version differ on "
                         f"{diff} of {n_px} pixels, or equal in {checks}")
    lattice, loaded = int(ref_samples.sum()), int(evaluated.sum())
    needed = int(work["in_blocks"].sum())
    # the grid, origin per batch row, direction, t0, t_stop per ray, the image
    nbytes = B * n_vox + B * 12 + n_px * 20 + n_px
    t_bytes = nbytes / PEAK_BYTES
    t_ops, t_ops_every = (n * OCC_SAMPLE_FLOPS / F32_FLOPS for n in (needed, lattice))
    rec = dict(hits=int(got.sum()), pixels_differing=diff, max_abs_err=0.0,
               occupied_voxels=int(occ.sum()), samples=lattice, samples_per_ray=lattice / n_px,
               evaluated=loaded, evaluated_per_ray=loaded / n_px,
               in_blocks_per_ray=needed / n_px,
               flagged_blocks=int(block_map.sum()), map_blocks=block_map.numel(),
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_ms_every_sample=max(t_bytes, t_ops_every) * 1e3,
               plain_ms=cuda_ms(lambda: rc_ops.occ_march_plain(occ, setup, cfg), 2),
               library_ms=None)
    if camera is not None:
        view, intr = camera
        # the wrapper as the step calls it: the ray set-up in PyTorch, then K7
        rec["ms_with_setup"] = device_ms(lambda: rc_ops.raycast_occ(occ, view, intr, cfg), 20)
        # how often the wrapper waits for the card (torch's sync debug mode warns
        # once for each operation that does; its other warning, that the mode is a
        # prototype, is not counted): never, since the set-up fills its divisors on
        # the card (ops/raycast.py::_div, _rdiv) and K7's map is its own launch
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rc_ops.raycast_occ(occ, view, intr, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        caught = [w for w in caught if "prototype" not in str(w.message)]
        rec["host_syncs_with_setup"] = len(caught)
        if caught:
            raise SystemExit(f"chip_smoke: raycast_occ {tag}: the ray set-up waited for the "
                             f"card {len(caught)} times: {[str(w.message)[:80] for w in caught]}")
    fn = (lambda: rc_ops.occ_march(occ, setup, cfg))
    lib = BASELINE.get("raycast")
    baseline = None
    if lib is not None and hasattr(lib, "spsg_raycast_occ"):
        old_samples = torch.empty_like(samples)
        old = baseline_occ_march(lib, occ, setup, cfg, old_samples)
        rec["baseline_pixels_differing"] = int((old != ref).sum())
        rec["baseline_samples_equal"] = torch.equal(old_samples.long(), ref_samples)
        if on_path:
            baseline = (lambda: baseline_occ_march(lib, occ, setup, cfg))
    time_in_turns(fn, baseline, 20, rec)
    if on_path:
        rec["kernels_ms"] = kernel_split_ms(fn)
    return rec


def occupancy_grids(grids):
    """The step's two occupancy masks of a make_chunk_batch (input and target
    from raycast_grids: training/step.py::_occupancy_masks) and an all-empty
    grid."""
    inp, tgt = grids["input"][0], grids["target"][0]
    return {"missing": geo_losses.missing_geo_mask(inp.abs() < 3.0 - 0.01, tgt, 3.0),
            "target_band": tgt.abs() < 1, "empty": torch.zeros_like(tgt, dtype=torch.bool)}


def look_along(eye, fwd, right):
    """cam2world (or cam2grid) at ``eye`` with camera z along ``fwd`` and x
    along ``right`` (y = z x x), as given: axis-aligned vectors stay exact."""
    cam = np.eye(4, dtype=np.float32)
    fwd, right = np.asarray(fwd, np.float64), np.asarray(right, np.float64)
    cam[:3, 0], cam[:3, 1], cam[:3, 2], cam[:3, 3] = right, np.cross(fwd, right), fwd, eye
    return cam


def look_at(eye, target, fx, image):
    """(cam2grid (4,4), intrinsics (4,)) of a camera at ``eye`` looking at
    ``target`` (xyz grid coordinates), principal point at the image centre."""
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross([0.0, 0.0, 1.0], f)
    return (look_along(eye, f, r / np.linalg.norm(r)),
            np.array([fx, fx, image[0] / 2.0, image[1] / 2.0], np.float32))


def adversarial_occ_grids(dims, image):
    """Grids and cameras (two batch rows each) made to catch a wrong K7 skip,
    as tests/test_torch_raycast_occ.py makes them at 32^3: ``corner_voxel``,
    one occupied voxel on a corner of three blocks' faces (a low face in z and
    x, a high face in y), seen by narrow cameras whose rays pass it a fraction
    of a voxel apart; ``face_rays``, a camera looking straight down from
    (x, y) = (8c - 0.5, 8c' - 0.5): the pixel column and row through the
    principal point run exactly on the face between voxels 8c - 1 and 8c (the
    nearest voxel is 8c, in the next block), their neighbours graze it, and
    occupied voxels lie on both sides; ``inside_shell``, a camera inside a
    closed shell |r - R| < 1 about the centre, its rays starting inside the
    occupied box. Returns {name: (occ, view, intr, cfg)} on the card."""
    Z, Y, X = dims
    w, h = image
    centre = np.array([X / 2.0, Y / 2.0, Z / 2.0])
    out = {}
    vz, vy, vx = 8 * (Z // 16), 8 * (Y // 16) - 1, 8 * (X // 16)
    occ = np.zeros((2,) + dims, bool)
    occ[:, vz, vy, vx] = True
    target = np.array([vx, vy, vz], np.float64)
    cams = [look_at(target + np.array([1.3, 1.7, 2.9]) * max(dims) / 2.0, target, 5.0 * w, image),
            look_at(target + np.array([-2.3, 0.6, 1.1]) * max(dims) / 2.0, target, 5.0 * w,
                    image)]
    out["corner_voxel"] = (occ, cams, 4 * max(dims))
    cx, cy = 8 * (X // 16) - 0.5, 8 * (Y // 16) - 0.5
    occ = np.zeros((2,) + dims, bool)
    ix, iy = int(cx + 0.5), int(cy + 0.5)  # the voxels 8c, 8c' on the faces' far side
    for b in range(2):
        occ[b, Z // 8: Z // 8 + 3, iy, ix] = True
        occ[b, Z // 4, iy - 1, ix - 1] = True
        occ[b, Z // 3, iy - 1: iy + 1, ix + 1] = True
        occ[b, Z // 2 - b, iy, ix - 2: ix] = True
    cam = np.array([[1, 0, 0, cx], [0, 1, 0, cy], [0, 0, -1, Z + 8.0], [0, 0, 0, 1]], np.float32)
    intr = np.array([2.0 * w, 2.0 * w, w / 2.0, h / 2.0], np.float32)
    out["face_rays"] = (occ, [(cam, intr), (cam, intr * np.float32([0.5, 0.5, 1, 1]))],
                        2 * Z + 16)
    zz, yy, xx = np.meshgrid(*(np.arange(n) for n in dims), indexing="ij")
    radius = min(dims) / 3.0
    r = np.sqrt((xx - centre[0]) ** 2 + (yy - centre[1] + 1.0) ** 2 + (zz - centre[2] - 1.0) ** 2)
    occ = np.broadcast_to(np.abs(r - radius) < 1.0, (2,) + dims).copy()
    eye = centre + np.array([0.2, -0.7, 0.9])
    cams = [look_at(eye, eye + [0.9, -0.8, 0.5], 0.4 * w, image),
            look_at(eye, eye + [-0.3, 0.4, -0.9], 0.4 * w, image)]
    out["inside_shell"] = (occ, cams, 2 * max(dims))
    res = {}
    for name, (occ, cams, depth_max) in out.items():
        cfg = rc_ops.RaycastConfig(width=w, height=h, depth_min=0.5, depth_max=float(depth_max))
        res[name] = (to_dev(occ), to_dev(np.stack([c[0] for c in cams])),
                     to_dev(np.stack([c[1] for c in cams])), cfg)
    return res


def rounding_rays():
    """Rays laid along the block face x = 15.5, one a batch row (four), made
    so that o + t d rounds onto the face (nearest voxel 16, occupied) at t =
    512 while the exact crossing is at t = 1024, within an 8^3 block whose
    first sample still lies on voxel 15 (tests/test_torch_raycast_occ.py::
    _rounding_rays: a skip past that block's box without K7's one-voxel
    margin misses every hit). Returns (occ, setup, cfg) on the card."""
    f32 = np.float32
    occ = np.zeros((4, 528, 8, 24), bool)
    origin, direction, t0 = [], [], []
    for b, y in enumerate((1, 3, 5, 7)):
        up = b < 2
        origin.append([f32(15.5) - f32(2.0 ** -20), y, 0.0 if up else 527.3])
        direction.append([[2.0 ** -30, 0.0, 1.0 if up else -1.0]])
        t0.append([(511.7 + 0.1 * b if up else 511.9) - 0.9 * 568])
        occ[b, slice(512, 520) if up else slice(8, 16), y, 16] = True
    t = lambda a: to_dev(np.asarray(a, np.float32))
    setup = rc_ops.MarchSetup(t(origin), t(direction), torch.ones((4, 1), device=DEV), t(t0),
                              torch.full((4, 1), 540.0, device=DEV))
    cfg = rc_ops.RaycastConfig(width=1, height=1, depth_min=0.0, depth_max=600.0,
                               ray_increment=0.9)
    return to_dev(occ), setup, cfg


def phase_compare_raycast():
    gen = torch.Generator().manual_seed(5)
    results = {k: [] for k in RAYCAST_KERNELS}
    tc = TrainConfig()
    for dims, image, on_path in RC_SHAPES:
        grids, view, intr = raycast_grids(dims, image, seed=11)
        cfg = rc_ops.RaycastConfig(width=image[0], height=image[1])
        n_vox = int(np.prod(dims))
        for name, (sdf, valid) in grids.items():
            tag = f"{name} {dims} {image}"
            base = dict(grid=name, dims=list(dims), image=list(image), main_path=on_path)
            rec, hits = compare_march(sdf, valid, view, intr, cfg, tag, on_path)
            results["raycast_march"].append(dict(base, **rec))
            shade_rec, scatter_rec = compare_shade_scatter(hits, n_vox, gen, tag, on_path)
            results["raycast_shade"].append(dict(base, **shade_rec))
            results["raycast_scatter"].append(dict(base, **scatter_rec))
        # the occupancy march at the step's shallower range (raycast_occ_depth_max)
        occ_cfg = dataclasses.replace(cfg, depth_max=tc.raycast_occ_depth_max / tc.voxelsize)
        for name, occ in occupancy_grids(grids).items():
            occ, setup = rc_ops.occ_setup(occ, view, intr, occ_cfg)
            rec = compare_occ(occ, setup, occ_cfg, f"{name} {dims} {image}", on_path,
                              camera=(view, intr))
            results["raycast_occ"].append(dict(grid=name, dims=list(dims), image=list(image),
                                               main_path=on_path, **rec))
            if on_path or name == "empty":
                # the hops: fewer samples loaded than walked past (at 16^3 a group's
                # loads past a ray's first hit can outnumber the skipped samples)
                if not rec["evaluated"] < rec["samples"]:
                    raise SystemExit(f"chip_smoke: raycast_occ {name} {dims}: K7 loaded "
                                     f"{rec['evaluated']} samples of {rec['samples']}")
        for name, (occ, aview, aintr, acfg) in adversarial_occ_grids(dims, image).items():
            occ, setup = rc_ops.occ_setup(occ, aview, aintr, acfg)
            rec = compare_occ(occ, setup, acfg, f"{name} {dims} {image}", False,
                              camera=(aview, aintr))
            if rec["hits"] < 3:
                raise SystemExit(f"chip_smoke: raycast_occ {name} {dims}: {rec['hits']} hits; "
                                 f"the adversarial grid is not seen")
            results["raycast_occ"].append(dict(grid=name, dims=list(dims), image=list(image),
                                               main_path=False, adversarial=True, **rec))
        del grids
        torch.cuda.empty_cache()
    occ, setup, rcfg = rounding_rays()
    rec = compare_occ(occ, setup, rcfg, "rounding_rays", False)
    if rec["hits"] != 4:
        raise SystemExit(f"chip_smoke: raycast_occ rounding_rays: {rec['hits']} of 4 rays hit")
    results["raycast_occ"].append(dict(grid="rounding_rays", dims=list(occ.shape[1:]),
                                       image=[1, 1], main_path=False, adversarial=True, **rec))
    keys = ("grid", "dims", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
    emit("compare_raycast",
         tolerance={"raycast_march": "hit, hit_idx, alpha, depth identical to the bit on every "
                                     "pixel; samples and evaluated equal to march_work_plain's",
                    "raycast_shade": "identical to the bit (int32 view), also on its edge "
                                     "cases",
                    "raycast_scatter": "1e-5 of each gradient's largest entry (atomic adds in "
                                       "another order), also with every hit on 8 voxels",
                    "raycast_occ": "identical on every pixel; samples equal to "
                                   "occ_march_plain's, evaluated to occ_march_work_plain's, "
                                   "the map to occ_skip_map_plain's; also on the adversarial "
                                   "grids"},
         summary={k: [{kk: r[kk] for kk in r if kk in keys or kk.endswith("_ms")} for r in v]
                  for k, v in results.items()},
         march_pixels_differing=sum(sum(r[k] for k in ("hit_diff", "hit_idx_diff",
                                                        "alpha_bits_diff", "depth_bits_diff"))
                                    for r in results["raycast_march"]))
    return results


# --------------------------------------------------------------------------- path
def randomise_bn_statistics(gen, seed):
    """BatchNorm running statistics away from (0, 1), so no norm is the identity."""
    rng = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in gen.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_((0.1 * torch.randn(buf.shape, generator=rng)).to(buf.device))
            elif name.endswith("running_var"):
                buf.copy_(torch.empty(buf.shape).uniform_(0.5, 1.5, generator=rng).to(buf.device))


def scale_conv_weights(gen, gain):
    """kaiming-uniform(a=sqrt(5)) weights shrink the signal layer by layer
    until every output is ~1e-7 and every logit a rounding away from the 0.5
    threshold; a gain of 2 keeps activations O(1), so that comparisons of
    outputs mean something."""
    with torch.no_grad():
        for p in gen.parameters():
            if p.dim() == 5:
                p.mul_(gain)


def centre_occupancy_head(gen, dims):
    """Random weights leave the occupancy logits of a scene all of one sign as
    often as not, and then nothing (or everything) is stitched. Shift the
    head's bias by the median logit of one synthetic chunk, so that about half
    of the voxels are predicted occupied and every accumulator gets work."""
    from spsg_tpu_torch.data import pipeline, synthetic

    s = synthetic.make_scene(dims=dims, seed=99)
    sample = pipeline.assemble_sample(s.sdf_input, s.sdf_complete, s.input_colors, s.colors,
                                      s.semantics, s.known, s.world2grid, 3.0, "lab", None)
    dev = gen.geo_occ_b.bias.device
    x = torch.from_numpy(sample["input"][None]).to(dev)
    m = torch.from_numpy(sample["mask"][None]).to(dev)
    with torch.no_grad():
        occ_l = gen.eval()(x, m, pred_color=False)[0]
        gen.geo_occ_b.bias -= occ_l.median()
    gen.train()


def classify(key):
    """Kind of a device kernel, from its name in the profiler's table."""
    k = key.lower()
    if "conv3x3_dw_kernel" in k:
        return "hand_dw"
    if "conv3x3_kernel" in k:
        return "hand_conv"
    if "reduce_partials" in k or "sum_slices" in k:
        return "hand_partial_reductions"
    for name in RAYCAST_KERNELS:  # K4's pre-pass and K6's zero and divide too
        if name in k:
            return name
    if any(t in k for t in ("cudnn", "xmma", "convolve", "conv", "gemm", "cutlass", "wgrad", "dgrad")):
        return "library_conv"
    return "elementwise"


def device_time_by_kind(prof, rename):
    """Device microseconds of a torch.profiler run by kind of kernel (``rename``
    maps the kinds of ``classify`` to the names of one part of a program) and by
    kernel name."""
    groups, names = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        kind = classify(e.key)
        kind = rename.get(kind, kind)
        groups[kind] = groups.get(kind, 0.0) + us
        names[e.key] = names.get(e.key, 0.0) + us
    return groups, names


def device_time_record(groups, names, top):
    """The record of a profile; "not measured" if it shows no device time."""
    total = sum(groups.values())
    if total <= 0:
        return "not measured"
    first = sorted(names.items(), key=lambda kv: -kv[1])[:top]
    return dict(total_ms=total / 1e3, by_kind_ms={k: v / 1e3 for k, v in sorted(groups.items())},
                top_kernels_ms=[[k[:80], v / 1e3] for k, v in first])


def profile_forward(gen, cb, mb):
    """Device time of one forward (a window batch, or a whole scene) by kind
    of kernel, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gen(cb, mb, pred_color=True, pred_semantic=True)
        torch.cuda.synchronize()
    groups = {"hand_conv3x3": 0.0, "hand_reduce_partials": 0.0, "library_conv": 0.0, "other": 0.0}
    measured, names = device_time_by_kind(prof, {
        "hand_conv": "hand_conv3x3", "hand_partial_reductions": "hand_reduce_partials",
        "elementwise": "other"})
    groups.update(measured)
    return device_time_record(groups, names, 8)


OUTPUTS = ("occ", "sdf", "color", "semantic")


def against_plain_twin(gen, plain, x, m, what):
    """One eval forward of ``gen`` (the hand kernels: 28 launches) and of its
    twin whose convs are the kernels' plain versions (no launch) on (x, m):
    every output within 1e-3 of the twin's and finite. Returns (seconds of
    gen's forward, max abs difference by output, max abs output by output)."""
    conv_ops.reset_launch_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.time()
        a = gen(x, m, pred_color=True, pred_semantic=True)
        torch.cuda.synchronize()
        seconds = time.time() - t
        n_kernel = sum(conv_ops.launch_counts.values())
        b = plain(x, m, pred_color=True, pred_semantic=True)
        torch.cuda.synchronize()
    if n_kernel != 28 or sum(conv_ops.launch_counts.values()) != 28:
        raise SystemExit(f"chip_smoke: {what}: the plain-version generator launched a kernel, "
                         "or the other one did not")
    diffs = {}
    for name, p, q in zip(OUTPUTS, a, b):
        d = (p - q).abs().max().item()
        if not (d <= 1e-3 and torch.isfinite(p).all()):
            raise SystemExit(f"chip_smoke: {what}, generator output {name}: kernels vs plain "
                             f"versions differ by {d:.3e}")
        diffs[name] = d
    return seconds, diffs, {n: p.abs().max().item() for n, p in zip(OUTPUTS, a)}


def seeded_generator(cfg):
    """The serving paths' generator: seeded random weights, activations kept
    O(1), BatchNorm statistics away from (0, 1), the occupancy head centred."""
    gen = state.init_generator(cfg, torch.Generator().manual_seed(0), DEV)
    scale_conv_weights(gen, 2.0)
    randomise_bn_statistics(gen, 1)
    centre_occupancy_head(gen, (128, 64, 64))
    return gen


def phase_path(tmp, par):
    cfg = TrainConfig()  # reference defaults: nf_gen 20, (128,64,64), colour + semantics
    gen = seeded_generator(cfg)
    ckpt = os.path.join(tmp, "model-seed0.pt")
    state.save_checkpoint(ckpt, gen, 0)
    del gen

    # the CLI keeps the stitched scene to itself: record what it passes on
    seen = {}
    real_run = chunked.run_chunked_inference

    def recording_run(generator, scene_input, scene_mask, *a, **kw):
        torch.cuda.synchronize()
        t = time.time()
        out = real_run(generator, scene_input, scene_mask, *a, **kw)
        torch.cuda.synchronize()
        seen.update(out=out, seconds=time.time() - t, generator=generator,
                    scene_input=scene_input, scene_mask=scene_mask, args=a, kwargs=kw)
        return out

    out_dir = os.path.join(tmp, "output")
    chunked.run_chunked_inference = recording_run
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    t = time.time()
    try:
        summary = cli.main(["--synthetic_scenes", "1", "--model_path", ckpt, "--output", out_dir,
                            "--num_to_vis", "1"])
    finally:
        chunked.run_chunked_inference = real_run
    cli_seconds = time.time() - t
    launches = all_launch_counts()

    want = {"conv3x3_act_stats": 23 * 4, "conv3x3": 5 * 4, "conv3x3_dw": 0,
            "raycast_march": 0, "raycast_shade": 0, "raycast_scatter": 0, "raycast_occ": 0,
            "tsdf_integrate": 0}
    if launches != want:
        raise SystemExit(f"chip_smoke: launches on the main path {launches}, expected {want}")
    out = seen["out"]
    dims = (128, 160, 192)
    got = out.counts > 0
    ok = (
        out.sdf.shape == dims and out.colors.shape == dims + (3,)
        and out.sem_labels.shape == dims and out.occ.shape == dims
        and np.isfinite(out.sdf[got]).all() and np.isneginf(out.sdf[~got]).all()
        and got.any() and out.geo_union > 0 and int(out.sem_labels.max()) < 14
        and np.isfinite(summary["geo_iou"]) and np.isfinite(summary["mean_iou"])
        and os.path.isfile(os.path.join(out_dir, "IoU.txt"))
    )
    if not ok:
        raise SystemExit("chip_smoke: the whole-scene outputs are not what they should be")
    iou_lines = open(os.path.join(out_dir, "IoU.txt")).read().split("\n")
    if len(iou_lines) != 30 or float(iou_lines[0]) != summary["geo_iou"]:
        raise SystemExit("chip_smoke: IoU.txt is not in the reference's format")
    # what the parallel phase runs again on two ranks, and holds to this run
    torch.save(dict(state_dict={k: v.cpu() for k, v in seen["generator"].state_dict().items()},
                    scene_input=seen["scene_input"], scene_mask=seen["scene_mask"],
                    args=seen["args"], kwargs=seen["kwargs"],
                    out={f: getattr(out, f) for f in CHUNKED_FIELDS}),
               os.path.join(par, "serve.pt"))
    rec = dict(
        scene=list(dims), windows=30, window_batches=4, launches=launches,
        seconds_per_scene=seen["seconds"], voxels_per_second=float(np.prod(dims)) / seen["seconds"],
        cli_seconds=cli_seconds, max_memory_allocated=torch.cuda.max_memory_allocated(),
        covered_voxels=int(got.sum()), geo_iou=summary["geo_iou"], mean_iou=summary["mean_iou"],
        vis_files=len(os.listdir(os.path.join(out_dir, "vis"))),
    )

    # the same scene fed raw (compact_scene, the CLI's --compact_feed): the clamp,
    # LAB and the mask on the card, against the host-assembled run above
    from spsg_tpu_torch.data import synthetic

    s = synthetic.make_scene(dims=dims, seed=100)  # the CLI's synthetic scene
    compact = dict(sdf=s.sdf_input.astype(np.float32), colors=s.input_colors, color_space="lab")
    torch.cuda.synchronize()
    t = time.time()
    out_c = chunked.run_chunked_inference(seen["generator"], None, None, *seen["args"],
                                          **dict(seen["kwargs"], compact_scene=compact))
    torch.cuda.synchronize()
    agree = float((out_c.counts == out.counts).mean())
    if not agree >= 0.999:
        raise SystemExit(f"chip_smoke: compact_scene: counts agree with the host-assembled run "
                         f"on {agree:.5f} of the voxels")
    rec["compact_feed"] = dict(seconds_per_scene=time.time() - t, counts_agree=agree,
                               host_assembled_seconds_per_scene=seen["seconds"],
                               geo_iou=out_c.geo_intersection / out_c.geo_union)
    del s, out_c

    # one window batch: kernels against the plain versions of the same layers
    gen = seen["generator"].eval()
    plain = state.make_generator(cfg, DEV, plain_convs=True).eval()
    plain.load_state_dict(gen.state_dict())
    pos = [(int(y), int(x)) for y, x in chunked.window_positions(dims[1:], 32)][8:16]
    sin = np.pad(seen["scene_input"], ((0, 0), (0, 64), (0, 64), (0, 0)))
    smask = np.pad(seen["scene_mask"], ((0, 0), (0, 64), (0, 64), (0, 0)))
    cb = torch.from_numpy(np.stack([sin[:, y:y + 64, x:x + 64] for y, x in pos])).to(DEV)
    mb = torch.from_numpy(np.stack([smask[:, y:y + 64, x:x + 64] for y, x in pos])).to(DEV)
    (rec["forward_seconds_window_batch"], rec["kernels_vs_plain_max_abs_diff"],
     rec["output_abs_max"]) = against_plain_twin(gen, plain, cb, mb, "window batch")
    rec["window_batch_device_time"] = profile_forward(gen, cb, mb)
    del plain, gen, cb, mb
    torch.cuda.empty_cache()

    # a small scene, GPU against CPU (the reference the CPU tests hold to JAX)
    from spsg_tpu_torch.data import pipeline, synthetic

    small = TrainConfig(input_dim=(16, 16, 16), nf_gen=4)
    s = synthetic.make_scene(dims=(16, 40, 48), seed=4)
    sample = pipeline.assemble_sample(s.sdf_input, s.sdf_complete, s.input_colors, s.colors,
                                      s.semantics, s.known, s.world2grid, 3.0, "lab", None)
    args = (sample["input"], sample["mask"], sample["target_sdf"], sample["known"],
            sample["semantics"])
    kw = dict(chunk_dims=(16, 16, 16), stride=8, window_batch=4)
    g = state.init_generator(small, torch.Generator().manual_seed(0), "cpu")
    scale_conv_weights(g, 2.0)
    randomise_bn_statistics(g, 2)
    centre_occupancy_head(g, (16, 16, 16))
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = chunked.run_chunked_inference(g, *args, device=dev, **kw)
    same = outs["cuda"].counts == outs["cpu"].counts
    both = same & (outs["cpu"].counts > 0)
    sdf_diff = float(np.abs(outs["cuda"].sdf[both] - outs["cpu"].sdf[both]).max())
    # thresholded voxels a rounding away from a boundary may flip: a share
    if not (same.mean() >= 0.999 and both.sum() > 100 and sdf_diff <= 1e-3):
        raise SystemExit(f"chip_smoke: small scene, GPU vs CPU: counts agree on {same.mean():.5f}, "
                         f"sdf differs by {sdf_diff:.3e}")
    rec["small_scene_gpu_vs_cpu"] = dict(counts_agree=float(same.mean()), sdf_max_abs_diff=sdf_diff)
    emit("path", **rec)
    return launches


# --------------------------------------------------------------------------- scene
SCENE_DIMS = (128, 160, 192)  # the test_scene CLI's synthetic scene (its defaults)
BIG_SCENE = (128, 260, 328)   # the reference's default bound (test_scene.py:33-37, 63)
SCENE_IMAGE = (480, 384)
SCENE_FILES = ["input", "input-normals", "target", "target-normals", "target-depth",
               "target-semantics", "pred", "pred-normals", "pred-depth", "pred-semantics"]


def reference_state_dict(gen):
    """``gen``'s weights under the original PyTorch reference's module names,
    as a reference .pth holds them (the inverse of
    models/convert.py::reference_to_torch_generator)."""
    sd = {k: v.cpu() for k, v in gen.state_dict().items()}
    bn = ("weight", "bias", "running_mean", "running_var")
    out = {}
    for prefix, layout in convert.REFERENCE_GENERATOR_LAYOUT.items():
        for conv_i, bn_i, name in layout:
            if f"{name}.weight" not in sd:
                continue
            out[f"{prefix}.{conv_i}.weight"] = sd[f"{name}.weight"]
            out[f"{prefix}.{conv_i}.bias"] = sd[f"{name}.bias"]
            if bn_i is not None:
                out.update({f"{prefix}.{bn_i}.{leaf}": sd[f"{name}.bn.{leaf}"] for leaf in bn})
                out[f"{prefix}.{bn_i}.num_batches_tracked"] = torch.tensor(0)
    for prefix, (name, bn_i) in convert.REFERENCE_HEAD_BN.items():
        out.update({f"{prefix}.{bn_i}.{leaf}": sd[f"{name}.{leaf}"] for leaf in bn})
    return out


def scene_render_kernels(args, cfg):
    """K4 and K5 against their plain versions on one of the scene CLI's
    renders (``args``: what it handed render_views): the march identical to
    the bit (compare_march, with its times and bound), the shade of the
    render's own attributes (colour, surface normals, semantics) identical to
    the bit, with times and bound as in compare_shade_scatter."""
    sdf, valid, colors01, sem, view, intr = args[:6]

    def dev(a):
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return a.to(DEV)[None].contiguous()

    s, v = dev(sdf), dev(valid)
    tag = f"scene prediction {tuple(sdf.shape)} {SCENE_IMAGE}"
    march_rec, (hit, _, depth, hit_idx) = compare_march(
        s, v, torch.from_numpy(view[None]).to(DEV), torch.from_numpy(intr[None]).to(DEV), cfg,
        tag, False)
    n = s[0].numel()
    rot = torch.from_numpy(np.linalg.inv(view)[None, :3, :3].astype(np.float32)).to(DEV)
    attrs = (dev(colors01).reshape(1, n, 3),
             normals3d.surface_normals(s, v, rot).reshape(1, n, 3).contiguous(),
             dev(sem).reshape(1, n, sem.shape[-1]))
    got = rc_ops.shade(*attrs, hit, hit_idx, depth)
    torch.cuda.synchronize()
    if not bits_equal(got, rc_ops.shade_plain(*attrs, hit, hit_idx, depth)):
        raise SystemExit(f"chip_smoke: raycast_shade {tag}: kernel and plain version differ")
    table = torch.cat(attrs, dim=-1)
    shade_rec = dict(
        hits=int(hit.sum()), max_abs_err=0.0, bound_ms=shade_bound_ms(hit, hit_idx, attrs),
        bound_by="bytes",
        plain_ms=cuda_ms(lambda: rc_ops.shade_plain(*attrs, hit, hit_idx, depth), 10),
        library_ms=device_ms(lambda: table[0, hit_idx[0].long()], 50),
        ms=device_ms(lambda: rc_ops.shade(*attrs, hit, hit_idx, depth), 50))
    base = dict(grid="scene_prediction", dims=list(sdf.shape), image=list(SCENE_IMAGE),
                main_path=False, path="scene")
    return dict(base, **march_rec), dict(base, **shade_rec)


def timed_scene(run, gen, scene_input, scene_mask, kw):
    """run(gen, ...) synchronised on the host clock, with its peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    out = run(gen, scene_input, scene_mask, **kw)
    torch.cuda.synchronize()
    return out, time.time() - t, torch.cuda.max_memory_allocated()


def phase_scene(tmp, rc_results, par):
    """The whole-scene CLI (spsg_tpu_torch.cli.test_scene) at its defaults from
    a reference-format .pth of the serving paths' seeded weights, and around
    it: the .pt of the same weights, the forward against its plain-conv twin at
    the scene's shape and at the reference's default bound, a bf16 scene, and
    K4 / K5 against their plain versions on the prediction's render."""
    from spsg_tpu_torch.cli import test_scene as scene_cli
    from spsg_tpu_torch.inference import whole_scene

    cfg = TrainConfig()  # nf_gen 20, colour + semantics, max_input_height 128
    gen = seeded_generator(cfg)
    pt, pth = os.path.join(tmp, "scene-seed0.pt"), os.path.join(tmp, "scene-seed0.pth")
    state.save_checkpoint(pt, gen, 0)
    torch.save({"epoch": 0, "state_dict": reference_state_dict(gen), "optimizer": {}}, pth)
    del gen

    # the CLI keeps the scene to itself: record what it passes on
    seen, renders = {}, []
    real_run, real_render = whole_scene.run_whole_scene, scene_cli.render_views

    def recording_run(generator, scene_input, scene_mask, **kw):
        seen["peak_before"] = torch.cuda.max_memory_allocated()
        out, seconds, peak = timed_scene(real_run, generator, scene_input, scene_mask, kw)
        seen.update(out=out, seconds=seconds, forward_peak=peak, generator=generator,
                    scene_input=scene_input, scene_mask=scene_mask, kwargs=kw)
        return out

    def recording_render(*args, **kw):
        torch.cuda.synchronize()
        t = time.time()
        images = real_render(*args, **kw)  # numpy images: the card is done
        renders.append(dict(args=args, seconds=time.time() - t,
                            hits=int(np.isfinite(images["depth"]).sum())))
        return images

    out_dir = os.path.join(tmp, "scene")
    whole_scene.run_whole_scene, scene_cli.render_views = recording_run, recording_render
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    t = time.time()
    try:
        scene_cli.main(["--synthetic_scenes", "1", "--model_path", pth, "--output", out_dir])
    finally:
        whole_scene.run_whole_scene, scene_cli.render_views = real_run, real_render
    cli_seconds = time.time() - t
    launches = all_launch_counts()
    peak = max(seen["peak_before"], torch.cuda.max_memory_allocated())

    want = {"conv3x3_act_stats": 23, "conv3x3": 5, "conv3x3_dw": 0, "raycast_march": 3,
            "raycast_shade": 3, "raycast_scatter": 0, "raycast_occ": 0, "tsdf_integrate": 0}
    if launches != want:
        raise SystemExit(f"chip_smoke: launches on the scene path {launches}, expected {want}")
    out = seen["out"]
    shapes = [o.shape for o in out]
    if shapes != [SCENE_DIMS, SCENE_DIMS, SCENE_DIMS + (3,), SCENE_DIMS + (14,)] or not all(
            np.isfinite(o).all() for o in out) or not (np.abs(out[1]) < 3.0).any():
        raise SystemExit(f"chip_smoke: the whole-scene outputs are not what they should be: "
                         f"{shapes}")
    names = set(os.listdir(out_dir))
    missing = sorted(({f"synthetic_scene_0_{k}.png" for k in SCENE_FILES}
                      | {"synthetic_scene_0_pred-mesh.ply"}) - names)
    if missing or len(renders) != 3 or not all(r["hits"] > 0 for r in renders):
        raise SystemExit(f"chip_smoke: the scene CLI wrote {sorted(names)}, missing {missing}; "
                         f"renders {[r['hits'] for r in renders]}")
    # what the parallel phase runs again on two ranks, and holds to this run
    torch.save(dict(state_dict={k: v.cpu() for k, v in seen["generator"].state_dict().items()},
                    scene_input=seen["scene_input"], scene_mask=seen["scene_mask"],
                    kwargs=seen["kwargs"], out=out), os.path.join(par, "scene.pt"))
    vox = float(np.prod(SCENE_DIMS))
    rec = dict(scene=list(SCENE_DIMS), image=list(SCENE_IMAGE), launches=launches,
               seconds_per_scene=seen["seconds"], voxels_per_second=vox / seen["seconds"],
               cli_seconds=cli_seconds, max_memory_allocated=peak,
               forward_max_memory_allocated=seen["forward_peak"],
               render_seconds={k: r["seconds"] for k, r in
                               zip(("input", "target", "prediction"), renders)},
               render_hits={k: r["hits"] for k, r in zip(("input", "target", "prediction"), renders)},
               files=len(names))

    # the .pt of the same weights: the same generator, the same outputs to the bit
    gen = seen["generator"].eval()
    g_pt, _ = state.load_checkpoint(pt, state.make_generator(cfg, DEV))
    same_weights = all(torch.equal(v, gen.state_dict()[k]) for k, v in g_pt.state_dict().items())
    again = real_run(g_pt, seen["scene_input"], seen["scene_mask"], **seen["kwargs"])
    if not (same_weights and all(np.array_equal(a, b) for a, b in zip(again, out))):
        raise SystemExit("chip_smoke: the scene from the .pth differs from the scene from the .pt "
                         f"of the same weights (weights equal: {same_weights})")
    rec["pth_equals_pt"] = True
    del g_pt, again

    # the forward at the scene's shape: device time by kind, and against the
    # plain-conv twin (K1 / K3 at these shapes against their plain versions)
    inp, msk, _ = whole_scene.pad_scene(seen["scene_input"], seen["scene_mask"], 3.0,
                                        seen["kwargs"]["max_height"])
    x, m = torch.from_numpy(inp[None]).to(DEV), torch.from_numpy(msk[None]).to(DEV)
    plain = state.make_generator(cfg, DEV, plain_convs=True).eval()
    plain.load_state_dict(gen.state_dict())
    (rec["forward_seconds"], rec["kernels_vs_plain_max_abs_diff"],
     rec["output_abs_max"]) = against_plain_twin(gen, plain, x, m, "scene")
    rec["forward_device_time"] = profile_forward(gen, x, m)

    # the reference's default bound: the scene in a (128, 260, 328) box
    big = np.zeros(BIG_SCENE + (4,), np.float32)
    big[..., 0] = -3.0
    big[:, :SCENE_DIMS[1], :SCENE_DIMS[2]] = inp
    big_mask = np.zeros(BIG_SCENE + (1,), np.float32)
    big_mask[:, :SCENE_DIMS[1], :SCENE_DIMS[2]] = msk
    _, seconds, big_peak = timed_scene(real_run, gen, big, big_mask, seen["kwargs"])
    xb, mb = torch.from_numpy(big[None]).to(DEV), torch.from_numpy(big_mask[None]).to(DEV)
    _, diffs, _ = against_plain_twin(gen, plain, xb, mb, f"scene {BIG_SCENE}")
    rec["reference_bound"] = dict(scene=list(BIG_SCENE), seconds_per_scene=seconds,
                                  voxels_per_second=float(np.prod(BIG_SCENE)) / seconds,
                                  max_memory_allocated=big_peak,
                                  kernels_vs_plain_max_abs_diff=diffs)
    del plain, x, m, xb, mb, big, big_mask
    torch.cuda.empty_cache()

    # one scene in bf16 (the kernels' bf16 variants, bf16 library convs, f32 heads)
    g16 = state.make_generator(dataclasses.replace(cfg, compute_dtype="bfloat16"), DEV)
    g16.load_state_dict(gen.state_dict())
    reset_all_launch_counts()
    out16, seconds, peak16 = timed_scene(real_run, g16, seen["scene_input"], seen["scene_mask"],
                                         seen["kwargs"])
    launches16 = all_launch_counts()
    if launches16 != dict(want, raycast_march=0, raycast_shade=0) or not all(
            np.isfinite(o).all() for o in out16):
        raise SystemExit(f"chip_smoke: the bf16 scene launched {launches16}, or is not finite")
    rec["bfloat16"] = dict(
        seconds_per_scene=seconds, voxels_per_second=vox / seconds, max_memory_allocated=peak16,
        launches=launches16,
        max_abs_diff_from_float32={n: float(np.abs(a - b).max())
                                   for n, a, b in zip(OUTPUTS, out16, out)},
        rms_diff_from_float32={n: float(np.sqrt(np.mean((a - b) ** 2.0)))
                               for n, a, b in zip(OUTPUTS, out16, out)})
    x, m = torch.from_numpy(inp[None]).to(DEV), torch.from_numpy(msk[None]).to(DEV)
    rec["bfloat16"]["forward_device_time"] = profile_forward(g16.eval(), x, m)
    del g16, out16, x, m

    # K4 / K5 on the prediction's render, against their plain versions
    cfg_rc = renders[2]["args"][6]
    march_rec, shade_rec = scene_render_kernels(renders[2]["args"], cfg_rc)
    rc_results["raycast_march"].append(march_rec)
    rc_results["raycast_shade"].append(shade_rec)
    rec["prediction_render"] = {k: {kk: r[kk] for kk in ("hits", "ms", "plain_ms", "library_ms",
                                                         "bound_ms", "bound_by")}
                                for k, r in (("raycast_march", march_rec),
                                             ("raycast_shade", shade_rec))}
    rec["prediction_render"]["raycast_march"]["samples_per_ray"] = march_rec["samples_per_ray"]
    print(f"scene: {SCENE_DIMS} {seen['seconds']:.4f} s a scene "
          f"({vox / seen['seconds']:.4g} voxels/s), peak {peak} bytes; {BIG_SCENE} "
          f"{rec['reference_bound']['seconds_per_scene']:.4f} s, peak {big_peak} bytes; bf16 "
          f"{rec['bfloat16']['seconds_per_scene']:.4f} s, peak {peak16} bytes", flush=True)
    emit("scene", **rec)
    return launches


# --------------------------------------------------------------------------- train
def profile_train_step(trainer, batch, flags):
    """Device time of one train step by kind of kernel, from torch.profiler:
    the step's three parts (forward and losses, backward, optimizer) traced one
    after the other, so that the forward kernel's launches for dx are told
    from its forward launches. "not measured" if the profiler shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    gen = trainer.generator.train()
    dev_batch = trainer._to_device(batch)
    trainer.optimizer.zero_grad(set_to_none=True)
    with profile(activities=acts) as p_fwd:
        loss, _, _ = trainer._forward_losses(dev_batch, flags)
        torch.cuda.synchronize()
    with profile(activities=acts) as p_bwd:
        loss.backward()
        torch.cuda.synchronize()
    for p in gen.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    with profile(activities=acts) as p_opt:
        trainer.optimizer.step()
        torch.cuda.synchronize()
    kinds, names = {}, {}
    for prof, rename in (
            (p_fwd, {"hand_conv": "hand_conv_forward", "library_conv": "library_conv_forward",
                     "elementwise": "elementwise_forward_and_losses"}),
            (p_bwd, {"hand_conv": "hand_conv_dx", "library_conv": "library_conv_backward",
                     "elementwise": "elementwise_backward"}),
            (p_opt, {k: "optimizer" for k in ("hand_conv", "library_conv", "elementwise")})):
        g, n = device_time_by_kind(prof, rename)
        for k, v in g.items():
            kinds[k] = kinds.get(k, 0.0) + v
        for k, v in n.items():
            names[k] = names.get(k, 0.0) + v
    return device_time_record(kinds, names, 10)


def rel_diff(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-12)


def leaf_gaps(a, b, what, module="generator"):
    """Parameter gradients of ``module`` of two trainers after the same step:
    ({name: max |a - b| over the largest |b|} over the leaves that have a
    gradient, [the leaves whose gradient is rounding noise on both sides])."""
    noise, errs = [], {}
    pb = dict(getattr(b, module).named_parameters())
    largest = max(p.grad.abs().max().item() for p in pb.values())
    for name, p in getattr(a, module).named_parameters():
        g, r = p.grad.float().cpu(), pb[name].grad.float().cpu()
        scale = r.abs().max().item()
        if scale <= 1e-6 * largest:
            # no gradient (the colour head without 2D losses), or one that is zero in
            # exact arithmetic and rounding noise in float32 (the bias of a conv that
            # feeds only train-mode BatchNorm): that small on both sides
            if not g.abs().max().item() <= 1e-6 * largest:
                raise SystemExit(f"chip_smoke: {what}: {name} has a gradient on one side only")
            if scale > 0.0:
                noise.append(name)
            continue
        errs[name] = (g - r).abs().max().item() / scale
    return errs, noise


def compare_grads(a, b, grad_tol, what, module="generator"):
    """Parameter gradients of ``module`` of two trainers after the same step,
    each within ``grad_tol`` of its largest entry; with ``grad_tol`` None the
    differences are reported, not held to a tolerance."""
    gaps, noise = leaf_gaps(a, b, what, module)
    errs = sorted((e, n) for n, e in gaps.items())
    worst, worst_name = errs[-1]
    if grad_tol is not None and not worst <= grad_tol:
        raise SystemExit(f"chip_smoke: {what}: gradient of {module} {worst_name} differs by "
                         f"{worst:.3e} of its largest entry; worst five {errs[-5:]}, "
                         f"median {errs[len(errs) // 2][0]:.3e}")
    return dict(grad_max_rel_diff=worst, grad_worst_parameter=worst_name,
                parameters_with_gradient=len(errs),
                grad_median_rel_diff=errs[len(errs) // 2][0],
                grad_worst_five=[[n, e] for e, n in errs[-5:]],
                gradients_of_rounding_noise=noise)


def compare_trainers(a, b, ma, mb, metric_tol, grad_tol, what):
    """Metrics and the generator's parameter gradients of two trainers after
    the same step (``grad_tol`` as in :func:`compare_grads`)."""
    if set(ma) != set(mb):
        raise SystemExit(f"chip_smoke: {what}: metrics {sorted(ma)} vs {sorted(mb)}")
    mdiff = {k: rel_diff(ma[k], mb[k]) for k in ma}
    bad = {k: v for k, v in mdiff.items() if not v <= metric_tol}
    if bad or not all(np.isfinite(float(v)) for v in ma.values()):
        raise SystemExit(f"chip_smoke: {what}: metrics differ: {bad}, {ma} vs {mb}")
    return dict(metrics_max_rel_diff=max(mdiff.values()), **compare_grads(a, b, grad_tol, what))


def centre_train_occupancy(trainer, batch):
    """The loss is masked to voxels the model predicts occupied; with random
    weights those may be none. Shift the occupancy head's bias by the median
    train-mode logit of this batch, so that half of the voxels count."""
    dev_batch = trainer._to_device(batch)
    gen = trainer.generator.train()
    with torch.no_grad():
        occ_l = gen(dev_batch["input"], dev_batch["mask"], pred_color=False)[0]
        gen.geo_occ_b.bias -= occ_l.median()


def phase_train():
    from spsg_tpu_torch.data import synthetic

    cfg = TrainConfig()  # reference defaults: nf_gen 20, (128,64,64), batch 2, lr 1e-4, Adam
    batch = synthetic.make_chunk_batch(cfg.batch_size, cfg.input_dim, seed=7)
    batch.pop("name")
    batch["weight_occ"] = np.float32(1.0)
    full, geo = StepFlags(**FULL_3D), StepFlags(**GEO_ONLY)

    trainer = Trainer(cfg, DEV, seed=0)
    scale_conv_weights(trainer.generator, 2.0)
    centre_train_occupancy(trainer, batch)
    twin = Trainer(cfg, DEV, seed=0, plain_convs=True)
    twin.generator.load_state_dict(trainer.generator.state_dict())
    before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}

    # (a) one step with the kernels, and the same step with the plain versions
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    metrics = trainer.step(batch, full)
    torch.cuda.synchronize()
    launches = all_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    twin_metrics = twin.step(batch, full)
    torch.cuda.synchronize()
    twin_peak = torch.cuda.max_memory_allocated()
    if all_launch_counts() != launches:
        raise SystemExit("chip_smoke: the plain-conv twin launched a kernel")
    # (b) launch counters of one step: 28 eligible convs forward, 25 backward (the
    # three convs of the colour head have no loss without the 2D terms); no raycast
    want = {"conv3x3_act_stats": 23, "conv3x3": 5 + 25, "conv3x3_dw": 25,
            "raycast_march": 0, "raycast_shade": 0, "raycast_scatter": 0, "raycast_occ": 0,
            "tsdf_integrate": 0}
    if launches != want:
        raise SystemExit(f"chip_smoke: launches of one train step {launches}, expected {want}")
    rec = dict(config=dict(nf_gen=cfg.nf_gen, input_dim=list(cfg.input_dim),
                           batch_size=cfg.batch_size, lr=cfg.lr, flags=FULL_3D),
               launches_per_step=dict(launches), max_memory_allocated=peak,
               twin_max_memory_allocated=twin_peak,
               first_step_metrics={k: float(v) for k, v in metrics.items()},
               kernels_vs_plain_twin=compare_trainers(trainer, twin, metrics, twin_metrics,
                                                      1e-4, 1e-2, "train step vs plain-conv twin"))
    if not (metrics["loss_occ"] > 0 and metrics["loss_sdf"] > 0 and metrics["loss_semantic"] > 0
            and 0 < metrics["iou_occ"] < 1):
        raise SystemExit(f"chip_smoke: the first step's losses are degenerate: {metrics}")
    del twin
    torch.cuda.empty_cache()

    # (c) three more steps, timed
    seconds, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        m = trainer.step(batch, full)
        torch.cuda.synchronize()
        seconds.append(time.time() - t)
        losses.append({k: float(v) for k, v in m.items()})
    after = trainer.generator.state_dict()
    finite = all(np.isfinite(v) for m in losses for v in m.values()) and all(
        torch.isfinite(v).all() for v in after.values())
    changed = [k for k, v in after.items() if not torch.equal(v, before[k])]
    unchanged = sorted(set(after) - set(changed))
    if not finite or trainer.iteration != 4:
        raise SystemExit(f"chip_smoke: training steps gave non-finite values: {losses}")
    # without 2D losses nothing reaches the colour head: with no weight decay it stays
    moved = (after["decoder_3a.bn.running_mean"] - before["decoder_3a.bn.running_mean"]).abs().max()
    if not (moved > 0 and "geo_0a.weight" in changed and "semantic_head_c.weight" in changed
            and set(unchanged) <= set(k for k in after if k.startswith("color_head_"))):
        raise SystemExit(f"chip_smoke: parameters that should move did not: unchanged {unchanged}")
    rec.update(seconds_per_step=sorted(seconds)[1], seconds_per_step_all=seconds,
               losses=[m["loss"] for m in losses], tensors_changed=len(changed),
               tensors_unchanged=unchanged)

    # geometry-only flags: the same code at a smaller depth
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t = time.time()
    gm = trainer.step(batch, geo)
    torch.cuda.synchronize()
    geo_seconds = time.time() - t
    want = {"conv3x3_act_stats": 9, "conv3x3": 2 + 11, "conv3x3_dw": 11,
            "raycast_march": 0, "raycast_shade": 0, "raycast_scatter": 0, "raycast_occ": 0,
            "tsdf_integrate": 0}
    if all_launch_counts() != want:
        raise SystemExit(f"chip_smoke: launches of one geometry-only step "
                         f"{all_launch_counts()}, expected {want}")
    if set(gm) != {"loss_occ", "iou_occ", "loss_sdf", "loss"} or not all(
            np.isfinite(float(v)) for v in gm.values()):
        raise SystemExit(f"chip_smoke: geometry-only step: {gm}")
    for k, v in all_launch_counts().items():
        launches[k] += v
    rec.update(geo_only=dict(launches_per_step=want, seconds=geo_seconds,
                             metrics={k: float(v) for k, v in gm.items()}))
    # a validation pass changes nothing
    state_before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    vm = trainer.step(batch, StepFlags(train=False, **FULL_3D))
    if trainer.iteration != 5 or not all(
            torch.equal(v, state_before[k]) for k, v in trainer.generator.state_dict().items()):
        raise SystemExit("chip_smoke: the validation pass changed the model")
    rec["validation_metrics"] = {k: float(v) for k, v in vm.items()}
    del state_before

    rec["step_device_time"] = profile_train_step(trainer, batch, full)

    # the same step with cuDNN choosing the algorithms of the 7 library convs by trial
    # (torch.backends.cudnn.benchmark), which the port does not switch on: a reading for
    # PERF.md of how much of the library convs' backward is cuDNN's default choice
    torch.backends.cudnn.benchmark = True
    try:
        seconds = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.time()
            trainer.step(batch, full)
            torch.cuda.synchronize()
            seconds.append(time.time() - t)
    finally:
        torch.backends.cudnn.benchmark = False
    rec["seconds_per_step_cudnn_benchmark"] = dict(first=seconds[0],
                                                   median_of_last_three=sorted(seconds[2:])[1])
    del trainer
    torch.cuda.empty_cache()

    # (d) a small step on the GPU against the same step on the CPU
    small = TrainConfig(input_dim=(16, 16, 16), nf_gen=4)
    sbatch = synthetic.make_chunk_batch(2, (16, 16, 16), seed=1)
    sbatch.pop("name")
    sbatch["weight_occ"] = np.float32(1.0)
    pair = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(small, dev, seed=3)
        scale_conv_weights(tr.generator, 2.0)
        pair[dev] = (tr, tr.step(sbatch, full))
    # gradients are reported only: at this size the loss sits on a few hundred voxels,
    # and one of them taking the other LeakyReLU slope (an activation within rounding
    # of 0) moves a gradient by percents (seen: 13 %); without such a voxel they agree
    # to 1e-5. The kernels' backward is held to 1e-4 in the compare phase.
    rec["small_step_gpu_vs_cpu"] = compare_trainers(
        pair["cuda"][0], pair["cpu"][0], pair["cuda"][1], pair["cpu"][1], 1e-4, None,
        "16^3 step, GPU vs CPU")
    emit("train", **rec)
    return launches


# --------------------------------------------------------------------------- train2d
FULL_2D = dict(pred_sdf=True, pred_color=True, pred_semantic=True, use_2d=True, use_disc=True)
# launches of one full step, from the code: the generator's 28 eligible convs
# forward (23 fused, 5 bare), and all 28 backward now that the 2D losses reach
# the colour head (dx by the forward kernel, dW by K2); three raycasts (input,
# projected target, prediction), of which only the prediction's has a backward
WANT_2D = {"conv3x3_act_stats": 23, "conv3x3": 5 + 28, "conv3x3_dw": 28,
           "raycast_march": 3, "raycast_shade": 3, "raycast_scatter": 1, "raycast_occ": 0,
           "tsdf_integrate": 0}
# the 2D and adversarial metrics of two float32 forwards part where a
# prediction pixel's hit flips (one pixel moves a mean over a few thousand by
# ~1e-4): those are held to 1e-3, the 3D metrics to 1e-4
METRICS_3D = ("loss_occ", "iou_occ", "loss_sdf", "loss_semantic")


@contextlib.contextmanager
def plain_raycast_inside():
    """Inside, the raycaster takes its plain versions on CUDA tensors too."""
    saved = (rc_ops.march, rc_ops.shade, rc_ops.scatter, rc_ops.occ_march)
    rc_ops.march, rc_ops.shade, rc_ops.scatter, rc_ops.occ_march = (
        rc_ops.march_plain, rc_ops.shade_plain, rc_ops.scatter_plain, rc_ops.occ_march_plain)
    try:
        yield
    finally:
        rc_ops.march, rc_ops.shade, rc_ops.scatter, rc_ops.occ_march = saved


def recording(trainer, seen):
    """Record the aux dict of the trainer's forward and the prediction's hits
    (the third raycast of a step) into ``seen``."""
    real_forward = trainer._forward_losses
    real_find = rc_ops.find_surface_crossings
    calls = []

    def forward(*a, **kw):
        calls.clear()
        out = real_forward(*a, **kw)
        seen["aux"] = out[2]
        seen["pred_hit"] = calls[2]["hit"] if len(calls) > 2 else None
        return out

    def find(*a, **kw):
        out = real_find(*a, **kw)
        calls.append(out)
        return out

    trainer._forward_losses = forward
    return find


def compare_metrics(ma, mb, what):
    if set(ma) != set(mb):
        raise SystemExit(f"chip_smoke: {what}: metrics {sorted(ma)} vs {sorted(mb)}")
    diffs = {k: rel_diff(ma[k], mb[k]) for k in ma}
    bad = {k: v for k, v in diffs.items() if not v <= (1e-4 if k in METRICS_3D else 1e-3)}
    if bad or not all(np.isfinite(float(v)) for v in ma.values()):
        raise SystemExit(f"chip_smoke: {what}: metrics differ: {bad}; {ma} vs {mb}")
    return diffs


def profile_train2d_step(trainer, batch, flags):
    """Device time of one full step by kind: the step's parts traced one after
    the other (generator forward with the 2D block; the discriminator's step
    and the adversarial forward; the generator's backward; its Adam), kernels
    told apart by name; the depth chain traced alone on the same frames. With
    style or content in ``flags``, the style block (``Trainer._style_content``:
    LAB to RGB, both VGG forwards, the Gram products, the losses, and its
    backward to the render) is traced alone too, on the render the step gave
    it, and its time moves out of the forward and backward kinds into "vgg"."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    dev_batch = trainer._to_device(batch)
    trainer.generator.train()
    params = list(trainer.generator.parameters())
    style_inputs = {}
    real_style = trainer._style_content

    def recording_style(render, images, missing2d, fl):
        style_inputs.update(render=render.detach(), images=images, missing2d=missing2d)
        return real_style(render, images, missing2d, fl)

    trainer._style_content = recording_style
    try:
        with profile(activities=acts) as p_fwd:
            loss_rest, metrics, aux = trainer._forward_losses(dev_batch, StepFlags(**flags))
            torch.cuda.synchronize()
    finally:
        del trainer._style_content
    with profile(activities=acts) as p_disc:
        gen_l = trainer._discriminator_step(StepFlags(**flags), aux, metrics, None, None)
        total = loss_rest + trainer.cfg.weight_discgen_loss * aux["gate2d"] * gen_l
        torch.cuda.synchronize()
    trainer.optimizer.zero_grad(set_to_none=True)
    with profile(activities=acts) as p_bwd:
        total.backward(inputs=params)
        torch.cuda.synchronize()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    with profile(activities=acts) as p_opt:
        trainer.optimizer.step()
        torch.cuda.synchronize()
    with profile(activities=acts) as p_depth:
        depth_ops.depth_to_normals(dev_batch["images_depth"], dev_batch["images_intrinsic"],
                                   trainer.cfg.max_depth_fill_iters)
        torch.cuda.synchronize()
    kinds, names = {}, {}
    everything = {k: "discriminator" for k in ("hand_conv", "library_conv", "elementwise")}
    forward = {"hand_conv": "hand_conv_forward", "library_conv": "library_conv_forward",
               "elementwise": "elementwise_forward_and_losses"}
    backward = {"hand_conv": "hand_conv_dx", "library_conv": "library_conv_backward",
                "elementwise": "elementwise_backward"}
    for prof, rename in (
            (p_fwd, forward), (p_disc, everything), (p_bwd, backward),
            (p_opt, {k: "optimizer" for k in ("hand_conv", "library_conv", "elementwise")})):
        g, n = device_time_by_kind(prof, rename)
        for k, v in g.items():
            kinds[k] = kinds.get(k, 0.0) + v
        for k, v in n.items():
            names[k] = names.get(k, 0.0) + v
    depth_us = sum(device_time_by_kind(p_depth, {})[0].values())
    # the depth chain runs inside the forward: its time moves out of that kind
    kinds["depth_chain"] = depth_us
    kinds["elementwise_forward_and_losses"] = kinds.get("elementwise_forward_and_losses",
                                                        0.0) - depth_us
    if style_inputs:
        render = style_inputs["render"].clone().requires_grad_(True)
        with profile(activities=acts) as p_sf:
            ls, lc = trainer._style_content(render, style_inputs["images"],
                                            style_inputs["missing2d"], StepFlags(**flags))
            torch.cuda.synchronize()
        with profile(activities=acts) as p_sb:
            (ls + lc).backward()
            torch.cuda.synchronize()
        kinds["vgg"] = 0.0
        vgg_names = {}
        for prof, rename in ((p_sf, forward), (p_sb, backward)):
            g, n = device_time_by_kind(prof, rename)
            for k, v in g.items():
                kinds[k] = kinds.get(k, 0.0) - v
                kinds["vgg"] += v
            for k, v in n.items():
                vgg_names[k] = vgg_names.get(k, 0.0) + v
        rec = device_time_record(kinds, names, 12)
        if isinstance(rec, dict):
            rec["vgg_top_kernels_ms"] = [[k[:80], v / 1e3] for k, v in
                                         sorted(vgg_names.items(), key=lambda kv: -kv[1])[:8]]
        return rec
    return device_time_record(kinds, names, 12)


@contextlib.contextmanager
def recording_views(seen):
    """Record into ``seen`` what a step computes that precompute_views also
    computes: the marches' hits ("find", in call order: input, target,
    prediction), the depth chain ("depth") and the occupancy masks ("occ")."""
    real = (rc_ops.find_surface_crossings, rc_ops.raycast_occ, depth_ops.depth_to_normals)

    def keep(key, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            seen.setdefault(key, []).append(out)
            return out
        return run

    rc_ops.find_surface_crossings, rc_ops.raycast_occ, depth_ops.depth_to_normals = (
        keep("find", real[0]), keep("occ", real[1]), keep("depth", real[2]))
    try:
        yield seen
    finally:
        rc_ops.find_surface_crossings, rc_ops.raycast_occ, depth_ops.depth_to_normals = real


def as_bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def views_differing(pre, seen):
    """Elements where precompute_views' entries differ from the step's own
    values, to the bit (0 everywhere is the check)."""
    normals, _, frames_ok = seen["depth"][0]
    pairs = {"images_normals": normals, "frames_ok": frames_ok,
             "missing2d": seen["occ"][0], "tgt_mask2d": seen["occ"][1]}
    for name, hits in (("in", seen["find"][0]), ("tgt", seen["find"][1])):
        pairs.update({f"{name}_{k}": hits[k] for k in ("hit", "hit_idx", "depth")})
    if set(pairs) != set(pre):
        raise SystemExit(f"chip_smoke: precompute_views gives {sorted(pre)}, "
                         f"the step {sorted(pairs)}")
    return {k: int((as_bits(pre[k]) != as_bits(v.reshape(pre[k].shape))).sum())
            for k, v in pairs.items()}


def missing_colour_step(batch):
    """One full step with weight_missing_color 2 (two occupancy raycasts, K7,
    weight the colour L1 and the discriminator's patches) against its twin with
    the plain convs and the plain raycaster; and precompute_views on the same
    batch against what the step computed, to the bit (K4 and K7 are
    deterministic, the depth chain is plain PyTorch). Returns (record,
    launches of the step)."""
    cfg = TrainConfig(weight_missing_color=2.0)
    flags = StepFlags(**FULL_2D)
    trainer = Trainer(cfg, DEV, seed=0)
    scale_conv_weights(trainer.generator, 2.0)
    centre_train_occupancy(trainer, batch)
    twin = Trainer(cfg, DEV, seed=0, plain_convs=True)
    twin.generator.load_state_dict(trainer.generator.state_dict())
    twin.discriminator.load_state_dict(trainer.discriminator.state_dict())
    twin.sn_state = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in trainer.sn_state.items()}
    seen = {}
    reset_all_launch_counts()
    with recording_views(seen):
        metrics = trainer.step(batch, flags)
        torch.cuda.synchronize()
    launches = all_launch_counts()
    want = dict(WANT_2D, raycast_occ=2)
    if launches != want:
        raise SystemExit(f"chip_smoke: launches of the missing-colour step {launches}, "
                         f"expected {want}")
    missing2d, tgt_mask2d = seen["occ"]
    weighted = int(((missing2d != 0) & (tgt_mask2d != 0)).sum())
    if not weighted > 0:
        raise SystemExit("chip_smoke: the missing-colour step weighted no pixel")
    reset_all_launch_counts()
    with plain_raycast_inside():
        twin_metrics = twin.step(batch, flags)
    torch.cuda.synchronize()
    if any(all_launch_counts().values()):
        raise SystemExit(f"chip_smoke: the plain twin launched a kernel: {all_launch_counts()}")
    rec = dict(launches_per_step=launches, weighted_pixels=weighted,
               metrics={k: float(v) for k, v in metrics.items()},
               kernels_vs_plain_twin=dict(
                   metrics_rel_diff=compare_metrics(metrics, twin_metrics,
                                                    "missing-colour step vs plain twin"),
                   generator_gradients=compare_grads(trainer, twin, 1e-2,
                                                     "missing-colour step vs plain twin")))
    del twin
    pre = trainer.precompute_views(batch)
    differing = views_differing(pre, seen)
    if any(differing.values()):
        raise SystemExit(f"chip_smoke: precompute_views differs from the step's own views: "
                         f"{differing}")
    # a sample's entries from a batch of one against the batch of two (reported:
    # the cache's sub-batches on the card)
    one = trainer.precompute_views({k: v[1:] for k, v in batch.items()
                                    if isinstance(v, np.ndarray) and v.ndim > 0})
    rec.update(precompute_vs_step_elements_differing=differing,
               precompute_batch_of_one_vs_two_elements_differing={
                   k: int((as_bits(v) != as_bits(pre[k][1:])).sum()) for k, v in one.items()})
    return rec, launches


def phase_train2d():
    from spsg_tpu_torch.data import synthetic

    cfg = TrainConfig()  # defaults: nf_gen 20, (128,64,64), batch 2, 320x256, nf_disc 8
    t = time.time()
    batch = synthetic.make_chunk_batch(cfg.batch_size, cfg.input_dim,
                                       (cfg.style_width, cfg.style_height), seed=7,
                                       with_frames=True, device=DEV)
    frames_seconds = time.time() - t
    batch.pop("name")
    batch["weight_occ"] = np.float32(cfg.weight_occ_loss)
    flags = StepFlags(**FULL_2D)
    rec = dict(config=dict(nf_gen=cfg.nf_gen, input_dim=list(cfg.input_dim),
                           batch_size=cfg.batch_size, image=[cfg.style_width, cfg.style_height],
                           nf_disc=cfg.nf_disc, patch_size=cfg.patch_size,
                           disc_loss_type=cfg.disc_loss_type, flags=FULL_2D),
               frames_seconds=frames_seconds,
               frame_holes=int((batch["images_depth"] == 0).sum()))

    trainer = Trainer(cfg, DEV, seed=0)
    scale_conv_weights(trainer.generator, 2.0)
    centre_train_occupancy(trainer, batch)
    twin = Trainer(cfg, DEV, seed=0, plain_convs=True)
    twin.generator.load_state_dict(trainer.generator.state_dict())
    twin.discriminator.load_state_dict(trainer.discriminator.state_dict())
    twin.sn_state = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in trainer.sn_state.items()}
    disc_before = {k: v.clone() for k, v in trainer.discriminator.state_dict().items()}

    # (a) one step with the kernels, and the same step of a twin with the plain
    # versions of the convs and of the raycaster
    seen, seen_twin = {}, {}
    find = recording(trainer, seen)
    real_find = rc_ops.find_surface_crossings
    reset_all_launch_counts()
    depth_ops.reset_host_syncs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc_ops.find_surface_crossings = find
    try:
        metrics = trainer.step(batch, flags)
        torch.cuda.synchronize()
    finally:
        rc_ops.find_surface_crossings = real_find
    launches = all_launch_counts()
    host_syncs = dict(depth_ops.host_syncs)
    peak = torch.cuda.max_memory_allocated()
    if launches != WANT_2D:
        raise SystemExit(f"chip_smoke: launches of one full step {launches}, expected {WANT_2D}")
    aux = seen["aux"]
    gate = dict(num_valid=int(aux["num_valid"]), min_num_valid_2d=cfg.min_num_valid_2d,
                gate2d=float(aux["gate2d"]), gate_depth=float(aux["gate_depth"]),
                valid_patches=int(aux["valid_patches"].sum()))
    disc_stepped = any(not torch.equal(v, disc_before[k])
                       for k, v in trainer.discriminator.state_dict().items())
    print(f"train2d: num_valid {gate['num_valid']} against min_num_valid_2d "
          f"{cfg.min_num_valid_2d}, gate {gate['gate2d']}, discriminator stepped: "
          f"{disc_stepped}", flush=True)
    if not (gate["gate2d"] == 1.0 and disc_stepped):
        raise SystemExit(f"chip_smoke: the full step ran with its gate closed: {gate}")

    find_twin = recording(twin, seen_twin)
    reset_all_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rc_ops.find_surface_crossings = find_twin
    try:
        with plain_raycast_inside():
            twin_metrics = twin.step(batch, flags)
        torch.cuda.synchronize()
    finally:
        rc_ops.find_surface_crossings = real_find
    twin_peak = torch.cuda.max_memory_allocated()
    if any(all_launch_counts().values()):
        raise SystemExit(f"chip_smoke: the plain twin launched a kernel: {all_launch_counts()}")
    pred_hit_diff = int((seen["pred_hit"] != seen_twin["pred_hit"]).sum())
    synth, synth_twin = seen["aux"]["synth"], seen_twin["aux"]["synth"]
    both = torch.isfinite(synth) & torch.isfinite(synth_twin)
    synth_diff = (synth - synth_twin)[both].abs().max().item()
    rec.update(
        launches_per_step=launches, depth_chain_host_syncs_per_step=host_syncs,
        gate=gate, discriminator_stepped=disc_stepped, max_memory_allocated=peak,
        twin_max_memory_allocated=twin_peak,
        first_step_metrics={k: float(v) for k, v in metrics.items()},
        kernels_vs_plain_twin=dict(
            metrics_rel_diff=compare_metrics(metrics, twin_metrics, "full step vs plain twin"),
            prediction_hit_pixels=int(seen["pred_hit"].sum()),
            prediction_hit_pixels_differing=pred_hit_diff, render_max_abs_diff=synth_diff,
            # the step's backward on the card (K6 inside the prediction's raycast,
            # the colour head's dx and dW) against autograd through the plain
            # versions, at the train phase's tolerance and for its reason
            generator_gradients=compare_grads(trainer, twin, 1e-2, "full step vs plain twin"),
            # reported only: no hand kernel is in the discriminator's backward, and
            # its gradients follow the render it is given, which the two forwards
            # round differently (render_max_abs_diff)
            discriminator_gradients=compare_grads(trainer, twin, None, "full step vs plain twin",
                                                  "discriminator")))
    if not (metrics["loss_depth"] > 0 and metrics["loss_color"] > 0 and metrics["loss_gen"] > 0):
        raise SystemExit(f"chip_smoke: the first full step's 2D losses are degenerate: {metrics}")
    del trainer._forward_losses, twin, synth, synth_twin, both
    seen.clear()
    seen_twin.clear()
    torch.cuda.empty_cache()

    # (b) one warm-up step, then three timed steps
    trainer.step(batch, flags)
    seconds, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        m = trainer.step(batch, flags)
        torch.cuda.synchronize()
        seconds.append(time.time() - t)
        losses.append({k: float(v) for k, v in m.items()})
    finite = all(np.isfinite(v) for m in losses for v in m.values()) and all(
        torch.isfinite(p).all() for p in list(trainer.generator.parameters())
        + list(trainer.discriminator.parameters()))
    if not finite or trainer.iteration != 5:
        raise SystemExit(f"chip_smoke: full steps gave non-finite values: {losses}")
    rec.update(seconds_per_step=sorted(seconds)[1], seconds_per_step_all=seconds,
               max_memory_allocated_steady=torch.cuda.max_memory_allocated(),
               losses=[m["loss"] for m in losses])
    # a validation pass changes nothing
    before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    dbefore = {k: v.clone() for k, v in trainer.discriminator.state_dict().items()}
    vm = trainer.step(batch, StepFlags(train=False, **FULL_2D))
    if trainer.iteration != 5 or not all(
            torch.equal(v, before[k]) for k, v in trainer.generator.state_dict().items()) \
            or not all(torch.equal(v, dbefore[k])
                       for k, v in trainer.discriminator.state_dict().items()):
        raise SystemExit("chip_smoke: the validation pass changed the model")
    rec["validation_metrics"] = {k: float(v) for k, v in vm.items()}
    del before, dbefore
    rec["step_device_time"] = profile_train2d_step(trainer, batch, FULL_2D)
    del trainer
    torch.cuda.empty_cache()

    # (d) the missing-colour weights and the cached views
    rec["missing_colour"], launches_mc = missing_colour_step(batch)
    torch.cuda.empty_cache()

    # (c) a small full step on the GPU against the same step on the CPU
    small = TrainConfig(input_dim=(16, 16, 16), nf_gen=4, nf_disc=4, style_width=48,
                        style_height=32, patch_size=16, max_depth_fill_iters=8,
                        min_num_valid_2d=10)
    sbatch = synthetic.make_chunk_batch(2, (16, 16, 16), (48, 32), seed=1, with_frames=True,
                                        device="cpu")
    sbatch.pop("name")
    sbatch["weight_occ"] = np.float32(1.0)
    pair = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(small, dev, seed=3)
        scale_conv_weights(tr.generator, 2.0)
        pair[dev] = (tr, {k: float(v) for k, v in tr.step(sbatch, flags).items()})
    # gradients reported only, as in the train phase's small step
    rec["small_step_gpu_vs_cpu"] = dict(
        metrics_rel_diff=compare_metrics(pair["cuda"][1], pair["cpu"][1],
                                         "16^3 full step, GPU vs CPU"),
        metrics_gpu=pair["cuda"][1],
        generator_gradients=compare_grads(pair["cuda"][0], pair["cpu"][0], None,
                                          "16^3 full step, GPU vs CPU"))
    emit("train2d", **rec)
    return launches, launches_mc, rec["step_device_time"]


# --------------------------------------------------------------------------- train2d_style
FULL_STYLE = dict(FULL_2D, compute_style=True, compute_content=True)


def fixed_seed_vgg(device):
    """load_vgg_for_style on ``device``; whether it fell back to the fixed-seed
    weights (this repository ships no VGG19 weights)."""
    from spsg_tpu_torch.models.vgg import load_vgg_for_style

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        vgg = load_vgg_for_style(device=device)
    return vgg, any("FIXED-SEED" in str(w.message) for w in caught)


def phase_train2d_style():
    """The full step with the VGG style / content losses at TrainConfig()
    width (both weights 1, both flags on), the VGG on fixed-seed weights."""
    from spsg_tpu_torch.data import colorspace, synthetic

    cfg = TrainConfig(weight_style_loss=1.0, weight_content_loss=1.0)
    batch = synthetic.make_chunk_batch(cfg.batch_size, cfg.input_dim,
                                       (cfg.style_width, cfg.style_height), seed=7,
                                       with_frames=True, device=DEV)
    batch.pop("name")
    batch["weight_occ"] = np.float32(cfg.weight_occ_loss)
    flags = StepFlags(**FULL_STYLE)
    vgg, fixed_seed = fixed_seed_vgg(DEV)
    rec = dict(config=dict(nf_gen=cfg.nf_gen, input_dim=list(cfg.input_dim),
                           batch_size=cfg.batch_size, image=[cfg.style_width, cfg.style_height],
                           color_space=cfg.color_space, weight_style_loss=cfg.weight_style_loss,
                           weight_content_loss=cfg.weight_content_loss, flags=FULL_STYLE),
               vgg_fixed_seed_weights=fixed_seed)

    trainer = Trainer(cfg, DEV, seed=0, vgg=vgg)
    scale_conv_weights(trainer.generator, 2.0)
    centre_train_occupancy(trainer, batch)
    # the same step, the same weights, both style weights 0
    zero = Trainer(dataclasses.replace(cfg, weight_style_loss=0.0, weight_content_loss=0.0),
                   DEV, seed=0, vgg=vgg)
    zero.generator.load_state_dict(trainer.generator.state_dict())
    zero.discriminator.load_state_dict(trainer.discriminator.state_dict())
    zero.sn_state = {k: {kk: vv.clone() for kk, vv in v.items()}
                     for k, v in trainer.sn_state.items()}

    # (a) one step: launches, peak memory, the style losses; the step with both
    # weights 0 on the same batch: the same forward, another generator gradient
    reset_all_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer.step(batch, flags)
    torch.cuda.synchronize()
    launches = all_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != WANT_2D:
        raise SystemExit(f"chip_smoke: launches of one style step {launches}, expected {WANT_2D}")
    style = {k: float(metrics[k]) for k in ("loss_style", "loss_content")}
    if not all(np.isfinite(v) and v > 0 for v in style.values()):
        raise SystemExit(f"chip_smoke: the style step's losses are not finite and positive: "
                         f"{style}")
    zero_metrics = zero.step(batch, flags)
    same_forward = {k: rel_diff(zero_metrics[k], metrics[k]) for k in style}
    # the style gradient reaches the generator through the render: K5 forward, K6
    # backward; without it the gradients are another step's
    moved = compare_grads(trainer, zero, None, "style step vs weights 0")
    if not (moved["grad_max_rel_diff"] > 1e-3 and max(same_forward.values()) <= 1e-5):
        raise SystemExit(f"chip_smoke: the style terms do not move the generator's gradients "
                         f"({moved}), or the two forwards differ ({same_forward})")
    rec.update(launches_per_step=launches, max_memory_allocated=peak,
               first_step_metrics={k: float(v) for k, v in metrics.items()},
               weights_0_vs_1=dict(style_losses_rel_diff=same_forward,
                                   generator_gradients=moved))
    del zero
    torch.cuda.empty_cache()

    # (b) one warm-up step, then three timed steps
    trainer.step(batch, flags)
    seconds, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        m = trainer.step(batch, flags)
        torch.cuda.synchronize()
        seconds.append(time.time() - t)
        losses.append({k: float(v) for k, v in m.items()})
    if not (all(np.isfinite(v) for m in losses for v in m.values())
            and all(torch.isfinite(p).all() for p in trainer.generator.parameters())):
        raise SystemExit(f"chip_smoke: style steps gave non-finite values: {losses}")
    rec.update(seconds_per_step=sorted(seconds)[1], seconds_per_step_all=seconds,
               max_memory_allocated_steady=torch.cuda.max_memory_allocated(),
               losses_style=[m["loss_style"] for m in losses],
               losses_content=[m["loss_content"] for m in losses])
    rec["step_device_time"] = profile_train2d_step(trainer, batch, FULL_STYLE)

    # (c) the VGG forward on the card against its CPU forward, on the step's
    # target frames in RGB (2, 256, 320, 3)
    images = torch.as_tensor(batch["images_color"], device=DEV).permute(0, 2, 3, 1)
    x = colorspace.lab01_to_rgb(images)
    vgg_cpu, _ = fixed_seed_vgg("cpu")
    vgg_cpu.load_state_dict({k: v.cpu() for k, v in vgg.state_dict().items()})
    with torch.no_grad():
        gpu = vgg(x)[0].cpu()
        cpu = vgg_cpu(x.cpu())[0]
    scale = cpu.abs().max().item()
    err = (gpu - cpu).abs().max().item() / scale
    if not err <= 1e-4:
        raise SystemExit(f"chip_smoke: the VGG forward on the card differs from the CPU's by "
                         f"{err:.3e} of the largest |feature|")
    rec["vgg_gpu_vs_cpu"] = dict(shape=list(x.shape), max_abs_err_rel=err, largest_feature=scale)
    del trainer, vgg_cpu, images, x
    torch.cuda.empty_cache()

    # (d) a small style step on the GPU against the same step on the CPU
    small = TrainConfig(input_dim=(16, 16, 16), nf_gen=4, nf_disc=4, style_width=48,
                        style_height=32, patch_size=16, max_depth_fill_iters=8,
                        min_num_valid_2d=10, weight_style_loss=1.0, weight_content_loss=1.0)
    sbatch = synthetic.make_chunk_batch(2, (16, 16, 16), (48, 32), seed=1, with_frames=True,
                                        device="cpu")
    sbatch.pop("name")
    sbatch["weight_occ"] = np.float32(1.0)
    pair = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(small, dev, seed=3, vgg=fixed_seed_vgg(dev)[0])
        scale_conv_weights(tr.generator, 2.0)
        pair[dev] = (tr, {k: float(v) for k, v in tr.step(sbatch, flags).items()})
    rec["small_step_gpu_vs_cpu"] = dict(
        metrics_rel_diff=compare_metrics(pair["cuda"][1], pair["cpu"][1],
                                         "16^3 style step, GPU vs CPU"),
        metrics_gpu=pair["cuda"][1])
    device = rec["step_device_time"]
    vgg_ms = device["by_kind_ms"].get("vgg") if isinstance(device, dict) else "not measured"
    print(f"train2d_style: {rec['seconds_per_step']:.4f} s a step, peak {peak} bytes, "
          f"vgg device time {vgg_ms} ms", flush=True)
    emit("train2d_style", **rec)
    return launches


# --------------------------------------------------------------------------- metrics
SCENE_NAME = "synthetic_scene_0"
# the scene's renders a FID set is made of: the prediction's and the target's
FID_KINDS = ("", "-normals", "-depth", "-semantics")


def phase_metrics(tmp, scene_dir):
    """The metrics CLI on the card over the scene phase's outputs: chamfer and
    IoU on its meshes (voxel units: --voxel_size 1), SSIM and Feature-l1 on
    its prediction and target renders, FID between its four prediction and
    four target renders; Inception-v3's seconds per image, peak memory and
    device time; its features and logits on the card against the CPU's."""
    import importlib

    from PIL import Image

    from spsg_tpu_torch.cli import metrics as metrics_cli
    from spsg_tpu_torch.inference import metrics as M

    versions = {}
    for name in ("scipy", "PIL", "pandas", "matplotlib"):
        try:
            versions[name] = importlib.import_module(name).__version__
        except ImportError:
            versions[name] = None
    print(f"metrics: host packages {json.dumps(versions)}", flush=True)
    if versions["scipy"] is None or versions["PIL"] is None:
        raise SystemExit(f"chip_smoke: the metrics need scipy and PIL: {versions}")

    meshes = ["--pred_suffix", "_pred-mesh.ply", "--target_suffix", "_target-mesh.ply"]
    pngs = ["--pred_suffix", "_pred.png", "--target_suffix", "_target.png"]
    fid_dirs = {}
    for side in ("pred", "target"):
        d = fid_dirs[side] = os.path.join(tmp, f"fid_{side}")
        os.makedirs(d)
        for kind in FID_KINDS:
            src = os.path.join(scene_dir, f"{SCENE_NAME}_{side}{kind}.png")
            os.symlink(src, os.path.join(d, f"{SCENE_NAME}{kind or '-colour'}.png"))
    runs = {
        "chamfer": ["--pred_dir", scene_dir, "--target_dir", scene_dir] + meshes,
        "iou": ["--pred_dir", scene_dir, "--target_dir", scene_dir, "--voxel_size", "1"] + meshes,
        "ssim": ["--pred_dir", scene_dir, "--target_dir", scene_dir] + pngs,
        "feature_l1": ["--pred_dir", scene_dir, "--target_dir", scene_dir] + pngs,
        "fid": ["--pred_dir", fid_dirs["pred"], "--target_dir", fid_dirs["target"],
                "--pred_suffix", ".png", "--target_suffix", ".png"],
    }
    rec = dict(host_packages=versions, cli={})
    reset_all_launch_counts()
    for metric, argv in runs.items():
        out = os.path.join(tmp, f"{metric}.txt")
        t = time.time()
        summary = metrics_cli.main(["--metric", metric, "--output", out] + argv)
        seconds = time.time() - t
        value = summary.get("fid") if metric == "fid" else summary.get("mean")
        if value is None or not np.isfinite(value) or not os.path.isfile(out):
            raise SystemExit(f"chip_smoke: metrics CLI --metric {metric} gave {summary}")
        rec["cli"][metric] = dict(value=value, seconds=seconds)
    if any(all_launch_counts().values()):
        raise SystemExit(f"chip_smoke: the metrics launched a hand kernel: {all_launch_counts()}")

    # Inception-v3 on the card: the eight renders, one forward an image
    images = [np.array(Image.open(os.path.join(fid_dirs[side], f)).convert("RGB")) / 255.0
              for side in ("pred", "target") for f in sorted(os.listdir(fid_dirs[side]))]
    M.image_features(images[:1], DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    feats = M.image_features(images, DEV)  # numpy: the card is done
    per_image = (time.time() - t) / len(images)
    peak = torch.cuda.max_memory_allocated()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        M.image_features(images[:1], DEV)
        torch.cuda.synchronize()
    device = device_time_record(*device_time_by_kind(prof, {"library_conv": "inception_conv"}), 6)
    cpu_feats = M.image_features(images, "cpu")
    scale = float(np.abs(cpu_feats).max())
    feat_err = float(np.abs(feats - cpu_feats).max()) / scale
    (_, la), (_, lb) = M._inception_outputs(images[:2], DEV)
    (_, ca), (_, cb) = M._inception_outputs(images[:2], "cpu")
    logit_scale = max(ca.abs().max().item(), cb.abs().max().item())
    logit_err = max((la.cpu() - ca).abs().max().item(),
                    (lb.cpu() - cb).abs().max().item()) / logit_scale
    fl_gpu = M.feature_l1(images[0], images[4], DEV)
    fl_cpu = M.feature_l1(images[0], images[4], "cpu")
    if not (feat_err <= 1e-4 and logit_err <= 1e-4
            and abs(fl_gpu - fl_cpu) <= 1e-4 * logit_scale):
        raise SystemExit(f"chip_smoke: Inception-v3 on the card differs from the CPU: features "
                         f"{feat_err:.3e}, logits {logit_err:.3e} of the largest entry; "
                         f"Feature-l1 {fl_gpu} vs {fl_cpu}")
    rec["inception"] = dict(
        images=len(images), image=list(images[0].shape), seconds_per_image=per_image,
        max_memory_allocated=peak, device_time_one_image=device,
        features_gpu_vs_cpu=feat_err, logits_gpu_vs_cpu=logit_err,
        feature_l1_gpu=fl_gpu, feature_l1_cpu=fl_cpu)
    cli_line = ", ".join(f"{k} {v['value']:.6g} ({v['seconds']:.2f} s)"
                         for k, v in rec["cli"].items())
    print(f"metrics: Inception-v3 {per_image * 1e3:.2f} ms an image, peak {peak} bytes; "
          f"{cli_line}", flush=True)
    emit("metrics", **rec)


# --------------------------------------------------------------------------- train_cli
# the train CLI at TrainConfig() width: 10 synthetic chunks in batches of 2 for
# 3 epochs, 5 iterations an epoch, the first geometry-only (num_iters_geo_only
# 0), the others full steps; the render cache holds every chunk (10 entries).
# The first epoch's 4 full steps miss it whole (the first of them is also the
# run's first full step and is reported apart), the third epoch's 5 hit it whole
CLI_CHUNKS, CLI_BATCH, CLI_EPOCHS = 10, 2, 3
CLI_ARGS = ["--synthetic_chunks", str(CLI_CHUNKS), "--batch_size", str(CLI_BATCH),
            "--max_epoch", str(CLI_EPOCHS), "--num_iters_geo_only", "0",
            "--cache_renders", str(CLI_CHUNKS)]


@contextlib.contextmanager
def recording_loop(steps, lookups):
    """Record each Trainer.step the loop makes (training or validation, with
    cached views or not, the launches inside it) and each RenderCache lookup
    (the samples it recomputed, the launches inside it). Every launch count
    is set to 0 as run_training starts, after the CLI has synthesised its
    chunks (whose frames are rendered with K4 and K5)."""
    from spsg_tpu_torch.training import loop as loop_mod

    real_step, real_lookup = Trainer.step, loop_mod.RenderCache.lookup
    real_run = loop_mod.run_training

    def run_training(*a, **kw):
        reset_all_launch_counts()
        return real_run(*a, **kw)

    def delta(before):
        return {k: v - before[k] for k, v in all_launch_counts().items()}

    def step(self, batch, flags, *a, **kw):
        before = all_launch_counts()
        out = real_step(self, batch, flags, *a, **kw)
        steps.append(dict(train=flags.train, use_2d=flags.use_2d,
                          cached=kw.get("precomp") is not None, launches=delta(before)))
        return out

    def lookup(self, *a, **kw):
        before, misses = all_launch_counts(), self.misses
        out = real_lookup(self, *a, **kw)
        lookups.append(dict(recomputed=self.misses - misses, launches=delta(before)))
        return out

    Trainer.step, loop_mod.RenderCache.lookup, loop_mod.run_training = step, lookup, run_training
    try:
        yield
    finally:
        Trainer.step, loop_mod.RenderCache.lookup, loop_mod.run_training = (
            real_step, real_lookup, real_run)


def adam_rule(a, b, module, lr, steps_taken):
    """Parameters of ``module`` of two trainers after the same steps from the
    same state, held to Queue C's Adam rule: each element within 2 * lr per
    step taken, and >= 99.9 % of the elements within 1e-5."""
    pb = dict(getattr(b, module).named_parameters())
    diffs = torch.cat([(p.detach() - pb[n].detach()).abs().reshape(-1)
                       for n, p in getattr(a, module).named_parameters()])
    largest, within = float(diffs.max()), float((diffs <= 1e-5).float().mean())
    if not (largest <= 2 * lr * steps_taken and within >= 0.999):
        raise SystemExit(f"chip_smoke: resumed run, {module}: parameters differ by up to "
                         f"{largest:.3e} (rule {2 * lr * steps_taken:.3e}), {within:.5f} of "
                         "them within 1e-5")
    return dict(max_abs_diff=largest, share_within_1e5=within)


def phase_train_cli(tmp, smi):
    """The train CLI in this process (spsg_tpu_torch.cli.train.main), then a
    resume of its last epoch from its checkpoint."""
    from spsg_tpu_torch.cli import train as train_cli
    from spsg_tpu_torch.utils import logging as port_logging

    save = os.path.join(tmp, "train")
    steps, lookups = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with recording_loop(steps, lookups):
        result = train_cli.main(CLI_ARGS + ["--save", save])
    torch.cuda.synchronize()
    seconds = time.time() - t
    launches = all_launch_counts()  # the loop's own: set to 0 as run_training started
    peak = torch.cuda.max_memory_allocated()

    # what it wrote
    ckpts = [f"model-epoch{e}.pt" for e in range(CLI_EPOCHS)]
    missing = [f for f in ["args.txt", "log.csv", "log_val.csv"] + ckpts
               if not os.path.isfile(os.path.join(save, f))]
    if missing:
        raise SystemExit(f"chip_smoke: the train CLI did not write {missing}")
    names = port_logging._HEADER_NAMES
    header = port_logging.make_header(["train"])[:-1] + [f"val_{h}" for h in names] + ["time"]
    val = open(os.path.join(save, "log_val.csv")).read().splitlines()
    rows = [dict(zip(header, map(float, line.split(",")))) for line in val[1:]]
    if val[0] != ",".join(header) or len(rows) != CLI_EPOCHS or not all(
            np.isfinite(v) for r in rows for v in r.values()):
        raise SystemExit(f"chip_smoke: log_val.csv: {val}")
    if any(rows[-1][k] == -1.0 for k in ("train_loss(depth)", "train_loss(disc)",
                                         "val_loss(depth)", "val_loss(disc)")):
        raise SystemExit(f"chip_smoke: log_val.csv's last row lacks the 2D losses: {rows[-1]}")

    # the iterations, the cache and the launches of each step
    per_epoch = CLI_CHUNKS // CLI_BATCH
    train_steps = [st for st in steps if st["train"]]
    full = [st for st in train_steps if st["use_2d"]]
    cache = result.render_cache
    if not (len(train_steps) == CLI_EPOCHS * per_epoch == result.iteration
            and len(full) == len(train_steps) - 1 == len(lookups)
            and all(st["cached"] for st in full) and cache.hits > 0):
        raise SystemExit(f"chip_smoke: the loop ran {len(train_steps)} steps ({len(full)} full, "
                         f"{len(lookups)} lookups) to iteration {result.iteration}, cache hits "
                         f"{cache.hits}")
    # a cached step marches the prediction only; a lookup that recomputes
    # marches its sub-batch's input and target grids once each
    if any(st["launches"]["raycast_march"] != 1 for st in full) or any(
            lk["launches"]["raycast_march"] != (2 if lk["recomputed"] else 0) for lk in lookups):
        raise SystemExit(f"chip_smoke: K4 launches of the cached steps "
                         f"{[st['launches']['raycast_march'] for st in full]}, of the lookups "
                         f"{[(lk['recomputed'], lk['launches']['raycast_march']) for lk in lookups]}")
    iterations, full_index = [], iter(lookups)
    for h, st in zip(result.timer.history, train_steps):
        kind = "geometry_only"
        if st["use_2d"]:
            n = next(full_index)["recomputed"]
            kind = ("first_full_step" if st is full[0] else "cache_hit" if n == 0
                    else "cache_miss" if n == CLI_BATCH else "cache_partial")
        iterations.append(dict(kind=kind, seconds=sum(h.values()),
                               **{f"{k}_seconds": v for k, v in h.items()}))
    by_kind = {}
    for it in iterations:
        by_kind.setdefault(it["kind"], []).append(it["seconds"])
    if min(len(by_kind.get(k, [])) for k in ("cache_miss", "cache_hit")) < 3:
        raise SystemExit(f"chip_smoke: fewer than 3 whole misses or whole hits after the first "
                         f"full step: {[it['kind'] for it in iterations]}")
    spread = {k: dict(n=len(v), median=sorted(v)[len(v) // 2], min=min(v), max=max(v))
              for k, v in by_kind.items()}

    # one checkpoint write of the whole training state
    path = os.path.join(tmp, "checkpoint.pt")
    torch.cuda.synchronize()
    t = time.time()
    state.save_checkpoint(path, result.trainer, CLI_EPOCHS)
    ckpt_seconds = time.time() - t
    ckpt_bytes = os.path.getsize(path)

    # the last epoch again, resumed from the second epoch's checkpoint
    resumed = train_cli.main(CLI_ARGS + ["--save", os.path.join(tmp, "resume"), "--no_vis",
                                         "--retrain", os.path.join(save, ckpts[-2])])
    a, b = resumed.trainer, result.trainer
    epochs = [torch.load(os.path.join(d, ckpts[2]), weights_only=True)["epoch"]
              for d in (save, os.path.join(tmp, "resume"))]
    adam_steps = {name: [[int(st["step"]) for st in getattr(tr, name).state.values()]
                         for tr in (a, b)] for name in ("optimizer", "disc_optimizer")}
    if not (resumed.iteration == result.iteration and epochs == [CLI_EPOCHS] * 2
            and all(x == y for x, y in adam_steps.values())):
        raise SystemExit(f"chip_smoke: the resumed run ended at iteration {resumed.iteration}, "
                         f"epochs {epochs}, Adam steps {adam_steps}; the unbroken one at "
                         f"{result.iteration}")
    cfg = b.cfg
    resume = dict(
        iteration=resumed.iteration, epoch=epochs[0],
        adam_steps={k: sorted(set(v[0])) for k, v in adam_steps.items()},
        generator=adam_rule(a, b, "generator", cfg.lr, per_epoch),
        discriminator=adam_rule(a, b, "discriminator", cfg.d_lr_factor * cfg.lr, per_epoch),
        buffers_max_abs_diff=max(float((v - b.generator.state_dict()[k]).abs().max())
                                 for k, v in a.generator.state_dict().items()
                                 if v.dtype.is_floating_point))
    rec = dict(nvidia_smi=smi, argv=CLI_ARGS, seconds=seconds, launches=launches,
               max_memory_allocated=peak, cache=dict(hits=cache.hits, misses=cache.misses),
               iterations=iterations, seconds_per_iteration=spread,
               # the loop's own host time: batch set-up, logging, and lookups that hit
               host_outside_step_per_iteration=[
                   it.get("setup_seconds", 0.0) + it.get("log_seconds", 0.0)
                   + (it.get("cache_seconds", 0.0) if it["kind"] == "cache_hit" else 0.0)
                   for it in iterations],
               checkpoint=dict(seconds=ckpt_seconds, bytes=ckpt_bytes),
               log_val_last_row={k: v for k, v in rows[-1].items() if v != -1.0},
               resume=resume)
    kinds = ", ".join(f"{k} {v['median']:.4f} ({v['min']:.4f}-{v['max']:.4f}, n {v['n']})"
                      for k, v in spread.items())
    print(f"train_cli: {smi}: seconds per iteration, median (range, n): {kinds}; "
          f"host outside the step {max(rec['host_outside_step_per_iteration']):.4f} s at most, "
          f"checkpoint {ckpt_bytes} bytes in {ckpt_seconds:.3f} s, peak {peak} bytes",
          flush=True)
    emit("train_cli", **rec)
    return launches


# --------------------------------------------------------------------------- main
# --------------------------------------------------------------------------- datagen
# the room of the datagen phase: 6.0 x 5.0 x 2.8 m, floor and four walls, no
# ceiling, a dozen boxes, every face cut to ~0.1 m
ROOM = (6.0, 5.0, 2.8)
ROOM_BOXES = 12
ROOM_FRAMES = 96
ROOM_VOXEL = 0.02


def room_mesh(seed=0):
    """(verts, faces, vertex colours, per-face category) of the datagen room:
    each quad a grid of ~0.1 m cells, colours from ``seed`` (a hue per quad,
    varied per vertex)."""
    rng = np.random.default_rng(seed)
    verts, faces, colors, cats = [], [], [], []

    def quad(o, a, b, cat):
        o, a, b = (np.asarray(v, np.float64) for v in (o, a, b))
        na = max(1, int(round(np.linalg.norm(a) / 0.1)))
        nb = max(1, int(round(np.linalg.norm(b) / 0.1)))
        i, j = np.meshgrid(np.arange(na + 1), np.arange(nb + 1), indexing="ij")
        v = o + (i / na)[..., None] * a + (j / nb)[..., None] * b
        base = sum(len(x) for x in verts)
        idx = base + i * (nb + 1) + j
        c0, c1, c2 = idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:]
        c3 = idx[:-1, 1:]
        f = np.concatenate([np.stack([c0, c1, c2], -1).reshape(-1, 3),
                            np.stack([c0, c2, c3], -1).reshape(-1, 3)])
        verts.append(v.reshape(-1, 3))
        faces.append(f)
        hue = rng.integers(40, 216, 3)
        colors.append(np.clip(hue + rng.integers(-30, 31, (len(v.reshape(-1, 3)), 3)), 0, 255))
        cats.append(np.full(len(f), cat))

    sx, sy, sz = ROOM
    quad([0, 0, 0], [sx, 0, 0], [0, sy, 0], 2)  # floor
    quad([0, 0, 0], [sx, 0, 0], [0, 0, sz], 1)  # walls
    quad([0, sy, 0], [sx, 0, 0], [0, 0, sz], 1)
    quad([0, 0, 0], [0, sy, 0], [0, 0, sz], 1)
    quad([sx, 0, 0], [0, sy, 0], [0, 0, sz], 1)
    for k in range(ROOM_BOXES):
        w, d, h = rng.uniform(0.4, 1.2), rng.uniform(0.4, 1.0), rng.uniform(0.3, 1.2)
        x0, y0 = rng.uniform(0.1, sx - w - 0.1), rng.uniform(0.1, sy - d - 0.1)
        cat = 3 + k % 10
        quad([x0, y0, h], [w, 0, 0], [0, d, 0], cat)
        quad([x0, y0, 0], [w, 0, 0], [0, 0, h], cat)
        quad([x0, y0 + d, 0], [w, 0, 0], [0, 0, h], cat)
        quad([x0, y0, 0], [0, d, 0], [0, 0, h], cat)
        quad([x0 + w, y0, 0], [0, d, 0], [0, 0, h], cat)
    return (np.concatenate(verts).astype(np.float32), np.concatenate(faces).astype(np.int64),
            np.concatenate(colors).astype(np.uint8), np.concatenate(cats).astype(np.int32))


def room_trajectory(n=ROOM_FRAMES, radius=1.2, height=1.5, tilt=0.45):
    """``n`` cameras on a circle of ``radius`` at ``height`` around the room's
    centre, looking outward and down."""
    cams = []
    for k in range(n):
        ang = 2 * np.pi * k / n
        eye = np.array([ROOM[0] / 2 + radius * np.cos(ang), ROOM[1] / 2 + radius * np.sin(ang),
                        height])
        fwd = np.array([np.cos(ang), np.sin(ang), -tilt])
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        cam = np.eye(4, dtype=np.float32)
        cam[:3, 0], cam[:3, 1], cam[:3, 2], cam[:3, 3] = right, np.cross(fwd, right), fwd, eye
        cams.append(cam)
    return cams


def grids_identical(a, b):
    """The four fields of two grids equal to the bit (float fields as int32)."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return {k: bool(torch.equal(bits(a[k]), bits(b[k]))) for k in a}


def write_region_ply(path, verts, faces, cats):
    """A labeled region PLY as tests/test_cli.py writes one."""
    import struct

    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z",
               f"element face {len(faces)}", "property list uchar int vertex_indices",
               "property int category_id", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(np.asarray(verts, "<f4").tobytes())
        rec = np.zeros(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3), ("c", "<i4")])
        rec["n"], rec["v"], rec["c"] = 3, faces, cats
        f.write(rec.tobytes())


def cull_stats(cull, dims):
    """Voxels of K8's launch for one frame: the box's, and those the
    intervals of the box's rows hold (what K8 walks), with their share of the
    grid."""
    z0, z1, y0, y1, x0, x1 = cull.box
    lo, hi = tsdf.row_intervals(cull.planes, dims)
    walked = int(np.clip(hi - lo + 1, 0, None)[z0:z1 + 1, y0:y1 + 1].sum())
    box = 0 if cull.empty else (z1 - z0 + 1) * (y1 - y0 + 1) * (x1 - x0 + 1)
    return dict(box=list(cull.box), box_voxels=box, walked_voxels=walked,
                walked_share=walked / float(np.prod(dims)))


def bind_tsdf_baseline(lib):
    """An older tsdf.cu: K8 over the whole grid (``spsg_tsdf_integrate``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spsg_tsdf_integrate.restype = i
    lib.spsg_tsdf_integrate.argtypes = [p] * 6 + [ctypes.c_longlong] + [i] * 5 + [p, p]
    return lib


def baseline_integrate(lib, grid, depth, color, intr, cam, w2g, cfg):
    """One frame through an older K8 (every voxel of the grid projected)."""
    Z, Y, X = grid["sdf"].shape
    H, W = depth.shape
    params = tsdf._frame_params(tsdf.voxel_to_camera(cam, w2g), intr, cfg)
    err = lib.spsg_tsdf_integrate(
        grid["sdf"].data_ptr(), grid["weight"].data_ptr(), grid["color"].data_ptr(),
        grid["free_ctr"].data_ptr(), depth.data_ptr(),
        None if color is None else color.data_ptr(), 0 if color is None else color.numel() // 3,
        Z, Y, X, H, W, params.ctypes.data, torch.cuda.current_stream(DEV).cuda_stream)
    if err:
        raise SystemExit(f"chip_smoke: the baseline's tsdf_integrate failed with error {err}")


def adversarial_k8_frames(grid, dims, w2g, cfg, sc):
    """K8 against integrate_plain to the bit (all four fields) on frames made
    to catch a wrong cull, each from a copy of the scanned room's grid (first
    observations and merges both happen): seeded dense depths in [0.3, 4.5] m
    with holes, from cameras looking exactly along +x and straight down from
    inside the room, from a camera just outside the grid's -y face looking
    along it (the frustum grazes the face), from one inside a corner of the
    grid, and from one outside looking away (no row to walk: K8 still
    launches, and counts, once); then a (3,3,3) grid whose voxel (0,0,0)
    lies on the optical axis at pz = 5e-10, in front of the camera (safe_z).
    Returns per frame the cull and the voxels changed."""
    lo = -np.array([cfg.scene_pad, cfg.scene_pad, cfg.height_pad]) * cfg.voxelsize
    hi = lo + np.array(dims[::-1]) * cfg.voxelsize
    mid = (lo + hi) / 2
    cams = {
        "along_+x": look_along(mid, (1, 0, 0), (0, -1, 0)),
        "straight_down": look_along(mid, (0, 0, -1), (1, 0, 0)),
        "grazing_-y_face": look_along([mid[0] - 2.0, lo[1] - 0.005, mid[2]], (1, 0, 0),
                                      (0, -1, 0)),
        "corner_inside": look_along(lo + 0.05, np.array([1, 1, 1]) / np.sqrt(3),
                                    np.array([1, -1, 0]) / np.sqrt(2)),
        "looking_away": look_along([hi[0] + 0.5, mid[1], mid[2]], (1, 0, 0), (0, -1, 0)),
    }
    intr = np.array([sc.fx, sc.fy, sc.width / 2, sc.height / 2], np.float32)
    rng = np.random.default_rng(7)
    out = {}

    def one(name, g, d, c, fintr, cam, fw2g, fdims):
        k8 = {k: v.clone() for k, v in g.items()}
        plain = {k: v.clone() for k, v in g.items()}
        before = all_launch_counts()["tsdf_integrate"]
        tsdf.integrate(k8, d, c, fintr, cam, fw2g, cfg)
        launched = all_launch_counts()["tsdf_integrate"] - before
        tsdf.integrate_plain(plain, d, c, fintr, cam, fw2g, cfg)
        torch.cuda.synchronize()
        same = grids_identical(k8, plain)
        changed = sum(int((g[k] != plain[k]).sum()) for k in g)
        cull = tsdf.frustum_cull(fdims, tuple(d.shape), fintr, cam, fw2g, cfg)
        if not all(same.values()) or launched != 1 or cull.empty != (changed == 0):
            raise SystemExit(f"chip_smoke: K8 on the adversarial frame {name}: identical "
                             f"{same}, launches {launched}, cull empty {cull.empty}, "
                             f"{changed} entries changed")
        out[name] = dict(identical=True, entries_changed=changed, **cull_stats(cull, fdims))

    for name, cam in cams.items():
        d = rng.uniform(0.3, 4.5, (sc.height, sc.width)).astype(np.float32)
        d[rng.random(d.shape) < 0.1] = np.nan
        c = rng.integers(0, 256, (sc.height, sc.width, 3)).astype(np.float32)
        one(name, grid, to_dev(d), to_dev(c), intr, cam, w2g, dims)
    if out["looking_away"]["walked_voxels"] or out["along_+x"]["entries_changed"] == 0:
        raise SystemExit(f"chip_smoke: the adversarial frames are not what they should be: "
                         f"{out}")
    tiny = tsdf.make_grid((3, 3, 3), DEV)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 3] = [0.0, 0.0, -5e-10]
    one("safe_z", tiny, torch.ones((8, 8), device=DEV), None,
        np.array([10.0, 10.0, 4.0, 4.0], np.float32), cam, np.eye(4, dtype=np.float32),
        (3, 3, 3))
    return out


def phase_datagen(tmp):
    """Dataset generation on the card: virtual_scan of the room (K8 a frame),
    K8 against integrate_plain to the bit, a small scan on the GPU against the
    CPU, then the datagen CLI (scan, chunk, semantics, filelist) and a chunk
    through the data loader."""
    from spsg_tpu_torch.cli import datagen as dg
    from spsg_tpu_torch.data import pipeline, synthetic
    from spsg_tpu_torch.datagen import raster, scan
    from spsg_tpu_torch.ops import mesh as mesh_ops

    verts, faces, colors, cats = room_mesh(seed=0)
    cfg = tsdf.FusionConfig(voxelsize=ROOM_VOXEL)
    sc = scan.ScanConfig()
    dims, w2g = tsdf.grid_from_bounds(verts.min(0), verts.max(0), cfg)
    traj = room_trajectory()
    rec = dict(room=dict(meters=list(ROOM), boxes=ROOM_BOXES, faces=len(faces),
                         vertices=len(verts), frames=len(traj), voxelsize=cfg.voxelsize,
                         grid=list(dims), grid_state_bytes=int(np.prod(dims)) * 24,
                         image=[sc.width, sc.height], chance_drop_frames=sc.chance_drop_frames))

    # (a) the scan, every integrate and save recorded
    frames, raster_s, saves, captured = [], [], [], {}
    real_raster, real_integrate, real_save = raster.rasterize_depth, tsdf.integrate, tsdf.save_grid

    def rasterize(*a, **kw):
        t = time.perf_counter()
        out = real_raster(*a, **kw)
        raster_s.append(time.perf_counter() - t)
        return out

    def integrate(grid, depth, color, intr, cam, world2grid, fcfg):
        frames.append((depth, color, np.asarray(intr, np.float32), np.asarray(cam, np.float32)))
        return real_integrate(grid, depth, color, intr, cam, world2grid, fcfg)

    def save(prefix, grid, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_save(prefix, grid, *a, **kw)
        saves.append(dict(prefix=os.path.basename(prefix), seconds=time.perf_counter() - t))
        if "__cmp__" in prefix:
            captured.update({k: v.clone() for k, v in grid.items()})

    inc, cmp_ = os.path.join(tmp, "room__inc__0"), os.path.join(tmp, "room__cmp__0")
    reset_all_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    raster.rasterize_depth, tsdf.integrate, tsdf.save_grid = rasterize, integrate, save
    t = time.time()
    try:
        out_dims, out_w2g = scan.virtual_scan(verts, faces, colors, traj, inc, cmp_,
                                              fusion_cfg=cfg, scan_cfg=sc, seed=0, device=DEV)
        torch.cuda.synchronize()
    finally:
        raster.rasterize_depth, tsdf.integrate, tsdf.save_grid = (
            real_raster, real_integrate, real_save)
    scan_seconds = time.time() - t
    launches = all_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if raster._LIB is None:
        raise SystemExit("chip_smoke: the native rasterizer did not load (numpy fallback)")
    if out_dims != dims or launches["tsdf_integrate"] != len(traj) or len(frames) != len(traj):
        raise SystemExit(f"chip_smoke: the scan fused {len(frames)} frames, K8 launched "
                         f"{launches}, dims {out_dims}; expected {len(traj)} and {dims}")
    scanned = captured
    rec.update(scan_seconds=scan_seconds, launches=launches, max_memory_allocated=peak,
               saves=saves, raster_ms_per_frame=1e3 * float(np.median(raster_s)),
               raster_ms_range=[1e3 * min(raster_s), 1e3 * max(raster_s)],
               observed_share=float((scanned["weight"] > 0).float().mean()))

    # (b) the same frames through K8 and through integrate_plain on the card, to
    # the bit after the first 8 frames and at the end; the end also equals the
    # scan's own grid
    k8, plain = tsdf.make_grid(dims, DEV), tsdf.make_grid(dims, DEV)
    checks = {}
    for i, (d, c, intr, cam) in enumerate(frames):
        tsdf.integrate(k8, d, c, intr, cam, w2g, cfg)
        tsdf.integrate_plain(plain, d, c, intr, cam, w2g, cfg)
        if i + 1 in (8, len(frames)):
            torch.cuda.synchronize()
            checks[i + 1] = grids_identical(k8, plain)
    checks["scan"] = grids_identical(k8, scanned)
    if not all(all(v.values()) for v in checks.values()):
        raise SystemExit(f"chip_smoke: K8 and integrate_plain disagree: {checks}")
    finite = torch.isfinite(k8["sdf"]) & torch.isfinite(plain["sdf"])
    err = max(float((k8[k] - plain[k]).abs().max()) for k in ("weight", "color"))
    err = max(err, float((k8["sdf"] - plain["sdf"])[finite].abs().max()))
    del plain, scanned
    rec["adversarial_frames"] = adversarial_k8_frames(k8, dims, w2g, cfg, sc)

    # (c) per frame: the upload, K8's device time, the plain version's, the bound
    d0, c0 = frames[0][0].cpu().numpy(), frames[0][1].cpu().numpy()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        torch.as_tensor(d0, device=DEV), torch.as_tensor(c0, device=DEV)
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t) / 20
    per_frame = []
    lib = BASELINE.get("tsdf")
    for i in range(0, len(frames), len(frames) // 8):
        d, c, intr, cam = frames[i]
        n_obs = tsdf.observed_voxels(dims, d, intr, cam, w2g, cfg)
        nbytes = n_obs * 48 + d.numel() * 4 + c.numel() * 4
        t = time.perf_counter()
        for _ in range(20):
            cull = tsdf.frustum_cull(dims, tuple(d.shape), intr, cam, w2g, cfg)
        fr = dict(frame=i, observed_voxels=n_obs, **cull_stats(cull, dims),
                  cull_host_ms=1e3 * (time.perf_counter() - t) / 20,
                  plain_ms=cuda_ms(lambda: tsdf.integrate_plain(k8, d, c, intr, cam, w2g, cfg),
                                   3),
                  bound_ms=nbytes / PEAK_BYTES * 1e3)
        time_in_turns(lambda: tsdf.integrate(k8, d, c, intr, cam, w2g, cfg),
                      None if lib is None else
                      (lambda: baseline_integrate(lib, k8, d, c, intr, cam, w2g, cfg)), 20, fr)
        per_frame.append(fr)
    del k8
    torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "bound_ms", "walked_share", "cull_host_ms") + (
        ("baseline_ms",) if lib is not None else ())
    mean = {k: float(np.mean([r[k] for r in per_frame])) for k in keys}
    kernel_rec = dict(main_path=True, grid=list(dims), image=[sc.width, sc.height],
                      max_abs_err=err, library_ms=None, bound_by="bytes", frames=per_frame,
                      **mean)
    rec.update(k8_vs_plain=checks, upload_ms_per_frame=upload_ms, k8=kernel_rec)

    # (d) a small scan (voxel 0.08, 6 frames: tests/test_cli.py) on the GPU and on
    # the CPU: the files identical byte for byte
    floor = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    floor_ply = os.path.join(tmp, "floor.ply")
    mesh_ops.save_ply(floor_ply, floor, np.array([[0, 1, 2], [0, 2, 3]], np.int64),
                      np.full((4, 3), 120, np.uint8))
    small = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"small_{dev}")
        dg.main(["scan", "--mesh", floor_ply, "--output_dir", out, "--voxelsize", "0.08",
                 "--num_frames", "6", "--device", dev])
        small[dev] = {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}
    if small["cuda"] != small["cpu"] or len(small["cuda"]) != 6:
        raise SystemExit(f"chip_smoke: the small scan's files differ between the GPU and the "
                         f"CPU: {[f for f in small['cpu'] if small['cuda'].get(f) != small['cpu'][f]]}")
    rec["small_scan_gpu_vs_cpu"] = dict(files=sorted(small["cuda"]), identical=True)

    # (e) the CLI on the card: scan at its defaults, chunk, semantics, filelist
    room_ply = os.path.join(tmp, "room.ply")
    mesh_ops.save_ply(room_ply, verts, faces, colors)
    cli_scans = os.path.join(tmp, "cli_scans")
    reset_all_launch_counts()
    t = time.time()
    dg.main(["scan", "--mesh", room_ply, "--output_dir", cli_scans])
    torch.cuda.synchronize()
    cli = dict(scan_seconds=time.time() - t, scan_launches=all_launch_counts()["tsdf_integrate"])
    if cli["scan_launches"] != 48:
        raise SystemExit(f"chip_smoke: the scan CLI launched K8 {cli['scan_launches']} times")
    chunks_dir = os.path.join(tmp, "chunks")
    t = time.time()
    dg.main(["chunk", "--inc", inc, "--cmp", cmp_, "--output_dir", chunks_dir, "--name", "room",
             "--chunk_dims", "128", "64", "64"])
    cli["chunk_seconds"] = time.time() - t
    region = os.path.join(tmp, "room_semseg.ply")
    write_region_ply(region, verts, faces, cats)
    t = time.time()
    dg.main(["semantics", "--region_ply", region,
             "--sdf_glob", os.path.join(chunks_dir, "*__cmp__*.sdf")])
    cli["semantics_seconds"] = time.time() - t
    dg.main(["filelist", "--chunk_dir", chunks_dir, "--train_list",
             os.path.join(tmp, "train.txt"), "--val_list", os.path.join(tmp, "val.txt")])
    names = sorted(os.listdir(chunks_dir))
    inc_chunks = [f for f in names if "__inc__" in f]
    sem_chunks = [f for f in names if "__sem__" in f]
    listed = [x for x in open(os.path.join(tmp, "train.txt")).read().split() if x] + [
        x for x in open(os.path.join(tmp, "val.txt")).read().split() if x]
    if not inc_chunks or len(sem_chunks) != len(inc_chunks) or sorted(listed) != inc_chunks:
        raise SystemExit(f"chip_smoke: chunk / semantics / filelist wrote {names}, listed {listed}")
    cli.update(chunks=len(inc_chunks))
    print("datagen: the category subcommand (matplotlib) is not driven here: the card's "
          "machine has no matplotlib (ROADMAP.md, Toolchain)", flush=True)

    # (f) one chunk through the data loader, its shapes those of a training chunk
    ds = pipeline.ChunkDataset([os.path.join(chunks_dir, inc_chunks[0])], load_semantic=True)
    sample = ds[0]
    ref = synthetic.make_chunk_batch(1, TrainConfig().input_dim, seed=1)
    shapes = {k: list(np.shape(v)) for k, v in sample.items() if isinstance(v, np.ndarray)}
    want = {k: list(np.shape(v))[1:] for k, v in ref.items()
            if isinstance(v, np.ndarray) and k in shapes}
    if not want or any(shapes[k] != v for k, v in want.items()):
        raise SystemExit(f"chip_smoke: a datagen chunk loads as {shapes}, a training chunk "
                         f"is {want}")
    # finite but for the target's -inf (unobserved), as the loader defines it
    tsdf_t = sample["target_sdf"]
    if not (all(np.isfinite(v).all() for k, v in sample.items() if k != "target_sdf"
                and isinstance(v, np.ndarray) and v.dtype.kind == "f")
            and np.isfinite(tsdf_t).any() and (np.isfinite(tsdf_t) | (tsdf_t == -np.inf)).all()):
        raise SystemExit("chip_smoke: a datagen chunk loads with non-finite values")
    cli["chunk_sample_shapes"] = shapes
    rec["cli"] = cli
    print(f"datagen: scan {scan_seconds:.2f} s ({len(traj)} frames), raster "
          f"{rec['raster_ms_per_frame']:.2f} ms a frame, upload {upload_ms:.3f} ms, K8 "
          f"{mean['ms']:.4f} ms (plain {mean['plain_ms']:.3f} ms, bound {mean['bound_ms']:.4f} ms), "
          f"saves {[round(s['seconds'], 3) for s in saves]} s, peak {peak} bytes", flush=True)
    emit("datagen", **rec)
    return launches, kernel_rec


# --------------------------------------------------------------------------- train2d_bf16
# the bf16 step's metrics against the float32 step's, same weights and batch:
# both round each block's output to bf16 (2^-8 relative) over some 20 layers;
# the 3D metrics within 1e-2 relative, the 2D and adversarial ones, moved too
# by prediction pixels whose hit flips, within 5e-2 (ROADMAP.md Queue C)
BF16_METRIC_TOL = (1e-2, 5e-2)


def compare_bf16_metrics(ma, mb, what):
    if set(ma) != set(mb):
        raise SystemExit(f"chip_smoke: {what}: metrics {sorted(ma)} vs {sorted(mb)}")
    diffs = {k: rel_diff(ma[k], mb[k]) for k in ma}
    bad = {k: v for k, v in diffs.items()
           if not v <= BF16_METRIC_TOL[0 if k in METRICS_3D else 1]}
    if bad or not all(np.isfinite(float(v)) for v in ma.values()):
        raise SystemExit(f"chip_smoke: {what}: metrics differ: {bad}; {ma} vs {mb}")
    return diffs


@contextlib.contextmanager
def conv_dtypes(seen):
    """Count the storage type of every launch of K1 / K3 (``_launch``) and K2
    (``_launch_dw``) into ``seen``."""
    real, real_dw = conv_ops._launch, conv_ops._launch_dw

    def launch(x, w, b):
        seen[("forward", str(x.dtype))] = seen.get(("forward", str(x.dtype)), 0) + 1
        return real(x, w, b)

    def launch_dw(x, dy):
        seen[("dw", str(x.dtype))] = seen.get(("dw", str(x.dtype)), 0) + 1
        return real_dw(x, dy)

    conv_ops._launch, conv_ops._launch_dw = launch, launch_dw
    try:
        yield
    finally:
        conv_ops._launch, conv_ops._launch_dw = real, real_dw


def phase_train2d_bf16(train2d_device):
    """The full step at TrainConfig() width with compute_dtype="bfloat16"."""
    from spsg_tpu_torch.data import synthetic

    cfg = TrainConfig(compute_dtype="bfloat16")
    batch = synthetic.make_chunk_batch(cfg.batch_size, cfg.input_dim,
                                       (cfg.style_width, cfg.style_height), seed=7,
                                       with_frames=True, device=DEV)
    batch.pop("name")
    batch["weight_occ"] = np.float32(cfg.weight_occ_loss)
    flags = StepFlags(**FULL_2D)
    trainer = Trainer(cfg, DEV, seed=0)
    scale_conv_weights(trainer.generator, 2.0)
    centre_train_occupancy(trainer, batch)
    f32 = Trainer(dataclasses.replace(cfg, compute_dtype=None), DEV, seed=0)
    f32.generator.load_state_dict(trainer.generator.state_dict())
    f32.discriminator.load_state_dict(trainer.discriminator.state_dict())
    f32.sn_state = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in trainer.sn_state.items()}

    # (a) one step: launches (K1-K3 all in their bf16 variants), peak memory
    seen = {}
    reset_all_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with conv_dtypes(seen):
        metrics = trainer.step(batch, flags)
        torch.cuda.synchronize()
    launches = all_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # the blocks' convs in bf16, the four heads' (geo_occ_b, geo_3c, color_head_c,
    # semantic_head_c) in float32: their forward and dx by K1, their dW by K2
    want_types = {("forward", "torch.bfloat16"): 56 - 8, ("forward", "torch.float32"): 8,
                  ("dw", "torch.bfloat16"): 28 - 4, ("dw", "torch.float32"): 4}
    if launches != WANT_2D or seen != want_types:
        raise SystemExit(f"chip_smoke: launches of one bf16 step {launches} (by storage type "
                         f"{seen}), expected {WANT_2D} ({want_types})")
    params = [p for p in trainer.generator.parameters()]
    adam = [v for s in trainer.optimizer.state.values() for k, v in s.items()
            if k in ("exp_avg", "exp_avg_sq")]
    if not (all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in params)
            and adam and all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in adam)
            and all(np.isfinite(float(v)) for v in metrics.values())):
        raise SystemExit("chip_smoke: the bf16 step left parameters or Adam state that are not "
                         f"finite float32, or metrics {metrics}")
    f32_metrics = f32.step(batch, flags)
    rec = dict(config=dict(compute_dtype=cfg.compute_dtype, nf_gen=cfg.nf_gen,
                           input_dim=list(cfg.input_dim), batch_size=cfg.batch_size,
                           image=[cfg.style_width, cfg.style_height], flags=FULL_2D),
               launches_per_step=launches,
               conv_launches_by_type={f"{a} {b}": v for (a, b), v in sorted(seen.items())},
               max_memory_allocated=peak,
               first_step_metrics={k: float(v) for k, v in metrics.items()},
               vs_float32_step=compare_bf16_metrics(metrics, f32_metrics, "bf16 vs f32 step"))
    del f32
    torch.cuda.empty_cache()

    # (b) one warm-up step, then three timed steps; device time by kind
    trainer.step(batch, flags)
    seconds = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        m = trainer.step(batch, flags)
        torch.cuda.synchronize()
        seconds.append(time.time() - t)
        if not all(np.isfinite(float(v)) for v in m.values()):
            raise SystemExit(f"chip_smoke: a bf16 step gave non-finite metrics: {m}")
    rec.update(seconds_per_step=sorted(seconds)[1], seconds_per_step_all=seconds,
               max_memory_allocated_steady=torch.cuda.max_memory_allocated(),
               step_device_time=profile_train2d_step(trainer, batch, FULL_2D),
               train2d_step_device_time=train2d_device)
    del trainer
    torch.cuda.empty_cache()

    # (c) the small step on the GPU against the CPU, both in bf16
    small = TrainConfig(input_dim=(16, 16, 16), nf_gen=4, nf_disc=4, style_width=48,
                        style_height=32, patch_size=16, max_depth_fill_iters=8,
                        min_num_valid_2d=10, compute_dtype="bfloat16")
    sbatch = synthetic.make_chunk_batch(2, (16, 16, 16), (48, 32), seed=1, with_frames=True,
                                        device="cpu")
    sbatch.pop("name")
    sbatch["weight_occ"] = np.float32(1.0)
    pair = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(small, dev, seed=3)
        scale_conv_weights(tr.generator, 2.0)
        pair[dev] = {k: float(v) for k, v in tr.step(sbatch, flags).items()}
    rec["small_step_gpu_vs_cpu"] = dict(
        metrics_rel_diff=compare_bf16_metrics(pair["cuda"], pair["cpu"],
                                              "16^3 bf16 step, GPU vs CPU"),
        metrics_gpu=pair["cuda"])
    total = rec["step_device_time"]
    print(f"train2d_bf16: {rec['seconds_per_step']:.4f} s a step, peak {peak} bytes, device "
          f"{total['total_ms'] if isinstance(total, dict) else total} ms (float32 step: "
          f"{train2d_device['total_ms'] if isinstance(train2d_device, dict) else train2d_device}"
          " ms)", flush=True)
    emit("train2d_bf16", **rec)
    return launches


# --------------------------------------------------------------------------- conv_forms
# GeneratorConfig's two flags for the convs the hand kernels do not take (both
# z-slab convs in the port: all seven, or the two 5^3 entry convs), and remat
FORM_FLAGS = ("zslab_conv", "folded_conv")
# the full step's launches with remat: every block's forward kernel once more
# in the backward (23 fused, 5 bare), the rest as WANT_2D
WANT_2D_REMAT = dict(WANT_2D, conv3x3_act_stats=2 * 23, conv3x3=2 * 5 + 28)
FORM_REPS = 5
# the gradient witness: the full step from these seeds' weights (batches 7 + seed)
WITNESS_SEEDS = (0, 1, 2)


def library_layers(gen, shape):
    """The blocks of ``gen`` that the hand kernels do not take, in call order,
    each with the input shape it gets in an eval forward of a (B, Z, Y, X)
    ``shape`` chunk: [(name, block, input shape)]."""
    seen = []
    hooks = [b.register_forward_pre_hook(
        lambda mod, args, name=n: seen.append((name, mod, tuple(args[0].shape))))
        for n, b in gen.named_modules() if isinstance(b, ConvBlock) and not b.eligible]
    x = torch.zeros(shape + (4,), device=DEV)
    try:
        with torch.no_grad():
            gen.eval()(x, x[..., :1], pred_color=True, pred_semantic=True)
    finally:
        for h in hooks:
            h.remove()
    return seen


def layer_fold(block, shape):
    """The fold the folded form (ops/folded_conv.py) takes for ``block`` on an
    input of ``shape``, None where it does not take the layer: the JAX
    package's rule (an odd SAME stride-1 conv, a fold other than (1, 1))."""
    k = block.weight.shape[2]
    if not (k % 2 == 1 and block.stride == 1 and block.dilation == 1
            and block.padding == k // 2):
        return None
    fold = pick_fold(shape[2], shape[3], block.weight.shape[0], k=k)
    return fold if fold != (1, 1) else None


def conv_form(form, block, fold=None):
    """(x channel-last, w (Cout, Cin, k, k, k)) -> channel-last output of one
    form ("library", "zslab", "folded"), without the bias."""
    s, p, d = block.stride, block.padding, block.dilation
    if form == "library":
        return lambda x, w: F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, s, p, d).permute(
            0, 2, 3, 4, 1)
    if form == "zslab":
        return lambda x, w: conv3d_zslab(x, w.permute(2, 3, 4, 1, 0), s, p, d)
    return lambda x, w: conv_folded(x, w.permute(2, 3, 4, 1, 0), fold)


def rel_err(a, b):
    """max |a - b| over the largest |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def form_values(fn, x, w, g):
    """y, dx, dW of one form under the cotangent ``g``."""
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = fn(xg, wg)
    dx, dw = torch.autograd.grad(y, (xg, wg), g)
    return y.detach(), dx, dw


def form_times(fn, x, w, g, reps=FORM_REPS):
    """Device ms (CUDA events) of one form: the forward, the input gradient
    alone (the weight not requiring one), the weight gradient alone, and
    forward + both gradients. A backward is timed on a graph kept from one
    forward, so it holds what that backward launches (the folded form's
    patch extraction included)."""
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with torch.no_grad():
        fwd = cuda_ms(lambda: fn(x, w), reps)
    y_dx, y_dw = fn(xg, w), fn(x, wg)
    dgrad = cuda_ms(lambda: torch.autograd.grad(y_dx, xg, g, retain_graph=True), reps)
    wgrad = cuda_ms(lambda: torch.autograd.grad(y_dw, wg, g, retain_graph=True), reps)
    both = cuda_ms(lambda: torch.autograd.grad(fn(xg, wg), (xg, wg), g), reps)
    del y_dx, y_dw
    return dict(forward_ms=fwd, dgrad_ms=dgrad, wgrad_ms=wgrad, forward_backward_ms=both)


def conv_forms_layers(gen, shape, backward=True):
    """Each library layer of ``gen`` at the input it gets from a ``shape``
    chunk, in each form that takes it: float32 values (y, and with
    ``backward`` dx and dW) against F.conv3d and its autograd within 1e-4 of
    each one's largest entry, and device times."""
    rng = torch.Generator().manual_seed(11)
    recs = []
    for name, block, xshape in library_layers(gen, shape):
        fold = layer_fold(block, xshape)
        x = torch.randn(xshape, generator=rng).to(DEV)
        w = block.weight.detach().clone()
        lib = conv_form("library", block)
        with torch.no_grad():
            yshape = tuple(lib(x, w).shape)
        g = torch.randn(yshape, generator=rng).to(DEV)
        k = w.shape[2]
        flops = 2.0 * k ** 3 * w.shape[1] * w.shape[0] * float(np.prod(yshape[:4]))
        rec = dict(layer=name, input=list(xshape), cout=w.shape[0], kernel=k,
                   stride=block.stride, fold=list(fold) if fold else None, flops=flops, forms={})
        forms = ["library", "zslab"] + (["folded"] if fold else [])
        ref = form_values(lib, x, w, g) if backward else None
        for form in forms:
            fn = conv_form(form, block, fold)
            if form != "library":
                if backward:
                    errs = [rel_err(a, b) for a, b in zip(form_values(fn, x, w, g), ref)]
                else:
                    with torch.no_grad():
                        errs = [rel_err(fn(x, w), lib(x, w))]
                if not max(errs) <= 1e-4:
                    raise SystemExit(f"chip_smoke: conv_forms {name} {xshape}: {form} against "
                                     f"F.conv3d, y / dx / dW off by {errs} of their largest entry")
                rec.setdefault("rel_err", {})[form] = errs
            if backward:
                t = form_times(fn, x, w, g)
            else:
                with torch.no_grad():
                    t = dict(forward_ms=cuda_ms(lambda: fn(x, w), FORM_REPS))
            t["forward_tflops"] = flops / t["forward_ms"] / 1e9
            rec["forms"][form] = t
        recs.append(rec)
        del x, g, ref
    torch.cuda.empty_cache()
    return recs


def conv_forms_bf16(gen, shape):
    """One bfloat16 forward per form against F.conv3d in bfloat16 (the
    kernels' bf16 rule: both round a float32 sum once): z-slab on the heaviest
    strided conv, folded on encoder_0a."""
    rng = torch.Generator().manual_seed(12)
    layers = {name: (block, xshape) for name, block, xshape in library_layers(gen, shape)}
    out = {}
    for form, name in (("zslab", "encoder_1a"), ("folded", "encoder_0a")):
        block, xshape = layers[name]
        x = torch.randn(xshape, generator=rng).to(DEV).bfloat16()
        w = block.weight.detach().bfloat16()
        with torch.no_grad():
            got = conv_form(form, block, layer_fold(block, xshape))(x, w)
            ref = conv_form("library", block)(x, w)
        if got.dtype != torch.bfloat16:
            raise SystemExit(f"chip_smoke: conv_forms bf16 {form} computed in {got.dtype}")
        out[form] = dict(layer=name, max_abs_err=check_y(got, ref, torch.bfloat16,
                                                         f"conv_forms bf16 {form} {name}"))
    return out


def conv_forms_steps(batch):
    """The full default step (train2d's configuration, weights and batch) and
    the same step with each form and with remat, each trainer from the same
    state: launches of the first step, its metrics and the generator's
    gradients against the default step's; then one warm-up and three timed
    steps (median seconds, peak memory) and device time by kind."""
    cfg = TrainConfig()
    flags = StepFlags(**FULL_2D)
    base = Trainer(cfg, DEV, seed=0)
    scale_conv_weights(base.generator, 2.0)
    centre_train_occupancy(base, batch)
    gsd = {k: v.clone() for k, v in base.generator.state_dict().items()}
    dsd = {k: v.clone() for k, v in base.discriminator.state_dict().items()}
    sn = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in base.sn_state.items()}
    trainers, recs, launches, first = {}, {}, {}, {}
    for name in ("default",) + FORM_FLAGS + ("remat",):
        tr = base if name == "default" else Trainer(
            dataclasses.replace(cfg, **{name: True}), DEV, seed=0)
        tr.generator.load_state_dict(gsd)
        tr.discriminator.load_state_dict(dsd)
        tr.sn_state = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in sn.items()}
        reset_all_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics = tr.step(batch, flags)
        torch.cuda.synchronize()
        launches[name] = all_launch_counts()
        want = WANT_2D_REMAT if name == "remat" else WANT_2D
        if launches[name] != want:
            raise SystemExit(f"chip_smoke: conv_forms: launches of the full step with {name} "
                             f"{launches[name]}, expected {want}")
        trainers[name], first[name] = tr, metrics
        recs[name] = dict(launches_per_step=launches[name],
                          first_step_max_memory_allocated=torch.cuda.max_memory_allocated(),
                          first_step_metrics={k: float(v) for k, v in metrics.items()})
        if name != "default":
            # metrics at train2d's rule; the generator's gradients within 1e-2 of a
            # leaf's largest entry (the LeakyReLU slope flips of the twin rule; the
            # gradient witness below measures them)
            recs[name]["against_default"] = dict(
                metrics_rel_diff=compare_metrics(metrics, first["default"],
                                                 f"full step with {name} vs default"),
                generator_gradients=compare_grads(tr, trainers["default"], 1e-2,
                                                  f"full step with {name} vs default"))
            recs[name]["against_default"]["gradients_identical"] = all(
                torch.equal(p.grad, q.grad) for p, q in zip(
                    tr.generator.parameters(), trainers["default"].generator.parameters()))
    for name, tr in trainers.items():
        tr.step(batch, flags)
        seconds = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.time()
            m = tr.step(batch, flags)
            torch.cuda.synchronize()
            seconds.append(time.time() - t)
        if not all(np.isfinite(float(v)) for v in m.values()):
            raise SystemExit(f"chip_smoke: conv_forms: the step with {name} is not finite: {m}")
        recs[name].update(seconds_per_step=sorted(seconds)[1], seconds_per_step_all=seconds,
                          max_memory_allocated_steady=torch.cuda.max_memory_allocated(),
                          step_device_time=profile_train2d_step(tr, batch, FULL_2D))
    return recs, launches, trainers


def generator_remat_bits(trainers, batch):
    """The generator alone (no raycaster, whose scatter adds atomically), one
    train forward and backward of a fixed loss from the same state: with remat
    against without, and without remat twice (what the card repeats of its
    own). Outputs, running statistics and gradients identical to the bit or
    not, and the gradients' largest difference over a leaf's largest entry."""
    dev_batch = trainers["default"]._to_device(batch)
    x, m = dev_batch["input"], dev_batch["mask"]
    sd = {k: v.clone() for k, v in trainers["default"].generator.state_dict().items()}
    runs = {}
    for key, name in (("default", "default"), ("remat", "remat"), ("default_again", "default")):
        gen = trainers[name].generator.train()
        gen.load_state_dict(sd)
        gen.zero_grad(set_to_none=True)
        outs = gen(x, m, pred_color=True, pred_semantic=True)
        sum((o.float() ** 2).mean() for o in outs).backward()
        torch.cuda.synchronize()
        runs[key] = ([o.detach() for o in outs],
                     {k: v.clone() for k, v in gen.state_dict().items()},
                     [p.grad.clone() for p in gen.parameters()])
    (oa, sa, ga) = runs["default"]
    out = {}
    for key in ("remat", "default_again"):
        ob, sb, gb = runs[key]
        out[f"{key}_vs_default"] = dict(
            outputs_identical=all(torch.equal(a, b) for a, b in zip(oa, ob)),
            running_statistics_identical=all(torch.equal(sa[k], sb[k]) for k in sa),
            gradients_identical=all(torch.equal(a, b) for a, b in zip(ga, gb)),
            gradient_max_rel_diff=max(rel_err(b, a) for a, b in zip(ga, gb)))
    return out


def _library_conv_float64(self, x, dt, halo):
    """ConvBlock._library_conv with F.conv3d in float64, forward and backward,
    its output rounded once to the block's type: the witness's yardstick."""
    y = F.conv3d(x.double().permute(0, 4, 1, 2, 3), self.weight.double(), None, self.stride,
                 self.padding, self.dilation)
    return y.permute(0, 2, 3, 4, 1).to(dt)


class SlopeSigns:
    """Forward pre-hooks on the BatchNorm of every ConvBlock with a LeakyReLU:
    the sign of each activation (that of its pre-activation, which LeakyReLU
    keeps), one bool tensor a block call, in call order."""

    def __init__(self, gen):
        self.signs = []
        self.hooks = [b.bn.register_forward_pre_hook(
            lambda mod, args: self.signs.append(args[0].detach() >= 0))
            for b in gen.modules() if isinstance(b, ConvBlock) and b.act and b.bn is not None]

    def remove(self):
        for h in self.hooks:
            h.remove()
        return self.signs


def slope_flips(signs, ref):
    """Activations whose LeakyReLU slope differs from ``ref``'s, and of how many."""
    if len(signs) != len(ref) or any(a.shape != b.shape for a, b in zip(signs, ref)):
        raise SystemExit("chip_smoke: conv_forms witness: the forwards called other blocks")
    return dict(flipped=int(sum((a != b).sum().item() for a, b in zip(signs, ref))),
                of=int(sum(a.numel() for a in ref)))


def conv_forms_gradient_witness(seeds=WITNESS_SEEDS):
    """Why the flags' steps part from the default step's gradients. For each
    seed (the trainer's weights, scaled and centred as in train2d, and the
    batch of seed 7 + seed), the full step from one state: with the seven
    library convs in float64 (the yardstick), the default step twice, and the
    step with each flag. Per leaf, each step's generator gradients against the
    yardstick's (and the flags' against the default's, the rule held above)
    over the leaf's largest entry: the worst leaf of each, the readings of
    every step on the leaf that is worst against the default; and the
    LeakyReLU slope flips of each step's forward against the yardstick's.
    Reported, not held: it says whether a flag's gap is its own fault or the
    float32 step's rounding, which the default step shows against the
    yardstick too."""
    from spsg_tpu_torch.data import synthetic

    cfg = TrainConfig()
    flags = StepFlags(**FULL_2D)
    names = ("float64", "default", "default_again") + FORM_FLAGS
    out = []
    for seed in seeds:
        batch = synthetic.make_chunk_batch(cfg.batch_size, cfg.input_dim,
                                           (cfg.style_width, cfg.style_height), seed=7 + seed,
                                           with_frames=True, device=DEV)
        batch.pop("name")
        batch["weight_occ"] = np.float32(cfg.weight_occ_loss)
        trainers, signs, metrics = {}, {}, {}
        for name in names:
            kw = {name: True} if name in FORM_FLAGS else {}
            tr = Trainer(dataclasses.replace(cfg, **kw), DEV, seed=seed)
            if name == "float64":
                scale_conv_weights(tr.generator, 2.0)
                centre_train_occupancy(tr, batch)
                gsd = {k: v.clone() for k, v in tr.generator.state_dict().items()}
                dsd = {k: v.clone() for k, v in tr.discriminator.state_dict().items()}
                sn = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in tr.sn_state.items()}
                for b in tr.generator.modules():
                    if isinstance(b, ConvBlock) and not b.eligible:
                        b._library_conv = _library_conv_float64.__get__(b)
            tr.generator.load_state_dict(gsd)
            tr.discriminator.load_state_dict(dsd)
            tr.sn_state = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in sn.items()}
            hooks = SlopeSigns(tr.generator)
            m = tr.step(batch, flags)
            torch.cuda.synchronize()
            signs[name] = hooks.remove()
            metrics[name] = {k: float(v) for k, v in m.items()}
            if not all(np.isfinite(v) for v in metrics[name].values()):
                raise SystemExit(f"chip_smoke: conv_forms witness seed {seed}: the step with "
                                 f"{name} is not finite: {metrics[name]}")
            trainers[name] = tr
        pairs = {f"{n}_vs_float64": (n, "float64") for n in names[1:]}
        pairs.update({f"{n}_vs_default": (n, "default") for n in ("default_again",) + FORM_FLAGS})
        gaps = {k: leaf_gaps(trainers[a], trainers[b], f"witness seed {seed} {k}")[0]
                for k, (a, b) in pairs.items()}
        leaf = max(gaps["zslab_conv_vs_default"], key=gaps["zslab_conv_vs_default"].get)
        rec = dict(seed=seed, batch_seed=7 + seed, zslab_worst_leaf=leaf,
                   on_zslab_worst_leaf={k: g[leaf] for k, g in gaps.items()})
        for k, g in gaps.items():
            worst = sorted(g, key=g.get)[-3:][::-1]
            rec[k] = dict(worst=[[n, g[n]] for n in worst],
                          median=float(np.median(list(g.values()))),
                          metrics_max_rel_diff=max(rel_diff(metrics[pairs[k][0]][q],
                                                            metrics[pairs[k][1]][q])
                                                   for q in metrics["float64"]))
        rec["slope_flips_vs_float64"] = {n: slope_flips(signs[n], signs["float64"])
                                         for n in names[1:]}
        rec["slope_flips_default_again_vs_default"] = slope_flips(signs["default_again"],
                                                                  signs["default"])
        out.append(rec)
        print(f"conv_forms witness seed {seed}: worst leaf against the default step "
              f"{leaf} " + ", ".join(f"{k} {v:.3e}" for k, v in rec["on_zslab_worst_leaf"].items())
              + "; worst leaf " + ", ".join(f"{k} {rec[k]['worst'][0][0]} "
                                            f"{rec[k]['worst'][0][1]:.3e}" for k in gaps)
              + "; slope flips against float64 " + ", ".join(
                  f"{n} {v['flipped']}" for n, v in rec["slope_flips_vs_float64"].items())
              + f" of {rec['slope_flips_vs_float64']['default']['of']}", flush=True)
        del trainers, signs
        torch.cuda.empty_cache()
    return out


def conv_forms_scene(par):
    """The scene phase's whole scene (its weights, input and outputs, kept in
    the parallel phase's directory) served by the generator with each form:
    launches, seconds, peak memory, device time of the forward by kind beside
    the default forward's, the outputs within 1e-3 of the default scene's."""
    from spsg_tpu_torch.inference import whole_scene

    saved = torch.load(os.path.join(par, "scene.pt"), weights_only=False)
    inp, msk, _ = whole_scene.pad_scene(saved["scene_input"], saved["scene_mask"], 3.0,
                                        saved["kwargs"]["max_height"])
    x, m = torch.from_numpy(inp[None]).to(DEV), torch.from_numpy(msk[None]).to(DEV)
    recs, launches = {}, {}
    for name in ("default",) + FORM_FLAGS:
        kw = {name: True} if name != "default" else {}
        gen = state.make_generator(TrainConfig(**kw), DEV)
        gen.load_state_dict(saved["state_dict"])
        gen.eval()
        reset_all_launch_counts()
        out, seconds, peak = timed_scene(whole_scene.run_whole_scene, gen, saved["scene_input"],
                                         saved["scene_mask"], saved["kwargs"])
        launches[name] = all_launch_counts()
        want = {**{k: 0 for k in launches[name]}, "conv3x3_act_stats": 23, "conv3x3": 5}
        diffs = {n: float(np.abs(a - b).max()) for n, a, b in zip(OUTPUTS, out, saved["out"])}
        if launches[name] != want or not max(diffs.values()) <= 1e-3 or not all(
                np.isfinite(o).all() for o in out):
            raise SystemExit(f"chip_smoke: conv_forms: the whole scene with {name}: launches "
                             f"{launches[name]}, outputs off the scene phase's by {diffs}")
        recs[name] = dict(launches=launches[name], seconds_per_scene=seconds,
                          max_memory_allocated=peak, max_abs_diff_from_scene_phase=diffs,
                          forward_device_time=profile_forward(gen, x, m))
        del gen, out
        torch.cuda.empty_cache()
    return recs, launches


def phase_conv_forms(par):
    """Phase conv_forms: the z-slab and folded forms and remat on the card."""
    from spsg_tpu_torch.data import synthetic

    t0 = time.time()
    use_true_float32()
    cfg = TrainConfig()
    # the forms are called on each library layer's weight directly
    gen = state.init_generator(cfg, torch.Generator().manual_seed(0), DEV)
    rec = dict(step_layers=conv_forms_layers(gen, (cfg.batch_size,) + tuple(cfg.input_dim)),
               scene_layers=[r for r in conv_forms_layers(gen, (1,) + SCENE_DIMS, backward=False)
                             if r["kernel"] == 5],
               bfloat16=conv_forms_bf16(gen, (cfg.batch_size,) + tuple(cfg.input_dim)))
    del gen
    batch = synthetic.make_chunk_batch(cfg.batch_size, cfg.input_dim,
                                       (cfg.style_width, cfg.style_height), seed=7,
                                       with_frames=True, device=DEV)
    batch.pop("name")
    batch["weight_occ"] = np.float32(cfg.weight_occ_loss)
    rec["steps"], step_launches, trainers = conv_forms_steps(batch)
    rec["generator_remat_bits"] = generator_remat_bits(trainers, batch)
    del trainers
    torch.cuda.empty_cache()
    rec["gradient_witness"] = conv_forms_gradient_witness()
    rec["scene"], scene_launches = conv_forms_scene(par)
    rec["seconds"] = time.time() - t0
    for r in rec["step_layers"]:
        print("conv_forms: " + r["layer"] + " " + str(r["input"]) + " -> " + str(r["cout"]) + ": "
              + ", ".join(f"{f} {t['forward_ms']:.3f} / {t['dgrad_ms']:.3f} / {t['wgrad_ms']:.3f}"
                          f" / {t['forward_backward_ms']:.3f} ms" for f, t in r["forms"].items()),
              flush=True)
    print("conv_forms: the full step " + ", ".join(
        f"{n} {r['seconds_per_step']:.4f} s, peak {r['max_memory_allocated_steady']}"
        + (f", gradients {g['grad_max_rel_diff']:.3e} ({g['grad_worst_parameter']})"
           if (g := r.get("against_default", {}).get("generator_gradients")) else "")
        for n, r in rec["steps"].items()) + f"; phase {rec['seconds']:.1f} s", flush=True)
    emit("conv_forms", **rec)
    paths = {f"train2d_{n}": step_launches[n] for n in FORM_FLAGS + ("remat",)}
    paths.update({f"scene_{n}": scene_launches[n] for n in FORM_FLAGS})
    return paths


# --------------------------------------------------------------------------- parallel
PAR_WORLD = 2
# the train CLI's few iterations: 4 chunks in global batches of 2 (one a rank),
# the full step from the first iteration
PAR_CLI_ARGS = ["--synthetic_chunks", "4", "--max_epoch", "1", "--num_iters_geo_only", "0",
                "--no_vis"]
# the kernels each parallel path must launch (the counts of both ranks, summed)
PAR_PATHS = {"parallel_train": CONV_KERNELS,
             "parallel_chunked": ("conv3x3", "conv3x3_act_stats"),
             "parallel_scene": ("conv3x3", "conv3x3_act_stats")}


def parallel_backend():
    """NCCL with a card of its own for each rank when there are two cards,
    else gloo with both ranks on the one card."""
    return "nccl" if torch.cuda.device_count() >= PAR_WORLD else "gloo"


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_part(rec, name, fn):
    """Run ``fn`` with the launch counters set to 0 just before and read just
    after; its seconds (host clock, synchronised) and peak memory into rec."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    rec[name] = dict(seconds=time.time() - t, launches=all_launch_counts(),
                     max_memory_allocated=torch.cuda.max_memory_allocated())
    return out


def parallel_rank(rank, port, cli_port, directory, backend):
    """One rank of the parallel phase, in a process of its own: the full train
    step on its row of the global batch, its share of the chunked scene's
    windows, its Y-slab of the whole scene (mesh= throughout), then the train
    CLI with --distributed. Writes rank<r>.pt into ``directory``."""
    from spsg_tpu_torch.cli import train as train_cli
    from spsg_tpu_torch.inference import whole_scene
    from spsg_tpu_torch.parallel import make_mesh, multihost, shard_batch

    shared = backend == "gloo"
    device = multihost.initialize(f"127.0.0.1:{port}", PAR_WORLD, rank, device_type="cuda",
                                  shared_card=shared, timeout_s=300)
    mesh = make_mesh(device)
    multihost.build_kernels(mesh)  # built by the parent: every rank only loads them
    rec, out = {"device": str(device), "backend": torch.distributed.get_backend()}, {}

    d = torch.load(os.path.join(directory, "train.pt"), weights_only=False)
    trainer = Trainer(TrainConfig(), device, seed=0, mesh=mesh)
    trainer.generator.load_state_dict(d["generator"])
    trainer.discriminator.load_state_dict(d["discriminator"])
    trainer.sn_state = {k: {kk: vv.to(device) for kk, vv in v.items()}
                        for k, v in d["sn_state"].items()}
    batch = shard_batch(d["batch"], mesh)
    metrics = rank_part(rec, "train", lambda: trainer.step(batch, StepFlags(**FULL_2D)))
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grads"] = {n: p.grad.cpu() for n, p in trainer.generator.named_parameters()}
    out["disc_grads"] = {n: p.grad.cpu() for n, p in trainer.discriminator.named_parameters()}
    out["params"] = {k: v.cpu() for k, v in trainer.generator.state_dict().items()}
    del trainer, batch, d
    torch.cuda.empty_cache()

    d = torch.load(os.path.join(directory, "serve.pt"), weights_only=False)
    gen = state.make_generator(TrainConfig(), device)
    gen.load_state_dict(d["state_dict"])
    kw = dict(d["kwargs"], device=device, mesh=mesh)
    res = rank_part(rec, "chunked", lambda: chunked.run_chunked_inference(
        gen, d["scene_input"], d["scene_mask"], *d["args"], **kw))
    if rank == 0:
        out["chunked"] = {f: getattr(res, f) for f in CHUNKED_FIELDS}
    elif res is not None:
        raise SystemExit("chip_smoke: run_chunked_inference returned a scene on rank 1")
    del res, d
    torch.cuda.empty_cache()

    d = torch.load(os.path.join(directory, "scene.pt"), weights_only=False)
    gen.load_state_dict(d["state_dict"])
    kw = dict(d["kwargs"], device=device, mesh=mesh)
    res = rank_part(rec, "scene", lambda: whole_scene.run_whole_scene(
        gen, d["scene_input"], d["scene_mask"], **kw))
    if rank == 0:
        out["scene"] = res
    else:  # every rank gets the whole scene: rank 1's is held to rank 0's by a digest
        out["scene_digest"] = [float(np.abs(o).astype(np.float64).sum()) for o in res]
    del res, d, gen
    torch.cuda.empty_cache()
    multihost.shutdown()

    # the train CLI as every rank of a user's launch calls it
    os.environ.update(SPSG_COORDINATOR=f"127.0.0.1:{cli_port}",
                      SPSG_NUM_PROCESSES=str(PAR_WORLD), SPSG_PROCESS_ID=str(rank))
    save = os.path.join(directory, f"cli_rank{rank}")
    argv = PAR_CLI_ARGS + ["--distributed", "--save", save] + (["--shared_card"] if shared else [])
    result = rank_part(rec, "train_cli", lambda: train_cli.main(argv))
    out["cli_params"] = {k: v.cpu() for k, v in result.trainer.generator.state_dict().items()}
    out["cli_files"] = sorted(os.listdir(save)) if os.path.isdir(save) else []
    out["rec"] = rec
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))


CHUNKED_FIELDS = ("sdf", "colors", "sem_labels", "occ", "counts", "geo_intersection", "geo_union",
                  "class_intersection", "class_union", "class_weight")


def phase_parallel(par, smi):
    """Two ranks (parallel_rank) against this process's single-process runs:
    the full train step on the same global batch and card, the chunked scene
    against the path phase's, the whole scene against the scene phase's."""
    from spsg_tpu_torch.data import synthetic

    backend = parallel_backend()
    print(f"parallel: {PAR_WORLD} ranks, backend {backend} "
          f"({'a card each' if backend == 'nccl' else 'both on one card'}); {smi}", flush=True)
    cfg = TrainConfig()
    batch = synthetic.make_chunk_batch(cfg.batch_size, cfg.input_dim,
                                       (cfg.style_width, cfg.style_height), seed=7,
                                       with_frames=True, device=DEV)
    batch.pop("name")
    batch["weight_occ"] = np.float32(cfg.weight_occ_loss)
    trainer = Trainer(cfg, DEV, seed=0)
    scale_conv_weights(trainer.generator, 2.0)
    centre_train_occupancy(trainer, batch)
    torch.save(dict(batch=batch,
                    generator={k: v.cpu() for k, v in trainer.generator.state_dict().items()},
                    discriminator={k: v.cpu()
                                   for k, v in trainer.discriminator.state_dict().items()},
                    sn_state={k: {kk: vv.cpu() for kk, vv in v.items()}
                              for k, v in trainer.sn_state.items()}),
               os.path.join(par, "train.pt"))
    single = {}
    metrics = rank_part(single, "train", lambda: trainer.step(batch, StepFlags(**FULL_2D)))
    metrics = {k: float(v) for k, v in metrics.items()}

    def on_cpu(grads):
        """A CPU trainer (the same module layout) holding ``grads`` as .grad."""
        t = Trainer(cfg, "cpu", seed=0)
        for module in ("generator", "discriminator"):
            for n, p in getattr(t, module).named_parameters():
                p.grad = grads[module][n]
        return t

    one = on_cpu({m: {n: p.grad.cpu() for n, p in getattr(trainer, m).named_parameters()}
                  for m in ("generator", "discriminator")})
    del trainer
    torch.cuda.empty_cache()  # the card to the ranks

    t = time.time()
    port, cli_port = free_port(), free_port()
    procs = []
    for r in range(PAR_WORLD):
        log = open(os.path.join(par, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r),
             "--parallel-ports", str(port), str(cli_port), "--parallel-dir", par,
             "--parallel-backend", backend], stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, 480 - (time.time() - t)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    ranks_seconds = time.time() - t
    logs = [open(os.path.join(par, f"rank{r}.log")).read() for r in range(PAR_WORLD)]
    if any(p.returncode != 0 for p, _ in procs):
        raise SystemExit("chip_smoke: parallel: rank exit codes "
                         f"{[p.returncode for p, _ in procs]}\n"
                         + "\n".join(f"--- rank {r}\n{t[-3000:]}" for r, t in enumerate(logs)))
    res = [torch.load(os.path.join(par, f"rank{r}.pt"), weights_only=False)
           for r in range(PAR_WORLD)]
    r0, r1 = res

    # (1) the step: both ranks alike, and against this process's step on the batch
    if r0["metrics"] != r1["metrics"]:
        raise SystemExit("chip_smoke: parallel: the ranks' metrics differ")
    for k in ("grads", "disc_grads", "params"):
        if not all(torch.equal(v, r1[k][n]) for n, v in r0[k].items()):
            raise SystemExit(f"chip_smoke: parallel: the ranks' {k} differ")
    two = on_cpu({"generator": r0["grads"], "discriminator": r0["disc_grads"]})
    train_rec = dict(metrics_rel_diff=compare_metrics(r0["metrics"], metrics,
                                                      "parallel train step"))
    train_rec.update(compare_grads(two, one, 1e-2, "parallel train step"))
    train_rec["discriminator"] = compare_grads(two, one, 1e-4, "parallel train step",
                                               "discriminator")

    # (2) the chunked scene: rank 0's against the path phase's single-process run
    serve = torch.load(os.path.join(par, "serve.pt"), weights_only=False)["out"]
    got = r0["chunked"]
    same_counts = got["counts"] == serve["counts"]
    both = same_counts & (serve["counts"] > 0)
    identical = {f: bool(np.array_equal(np.asarray(got[f]), np.asarray(serve[f])))
                 for f in CHUNKED_FIELDS}
    chunk_rec = dict(identical=identical, counts_agree=float(same_counts.mean()),
                     sdf_max_abs_diff=float(np.abs(got["sdf"][both] - serve["sdf"][both]).max()),
                     colors_max_abs_diff=int(np.abs(got["colors"][both].astype(int)
                                                    - serve["colors"][both].astype(int)).max()))
    if not all(identical.values()):
        raise SystemExit(f"chip_smoke: parallel chunked scene vs one process: {chunk_rec}")

    # (3) the whole scene: rank 0's against the scene phase's, within 1e-4
    scene_ref = torch.load(os.path.join(par, "scene.pt"), weights_only=False)["out"]
    diffs = {n: float(np.abs(a - b).max()) for n, a, b in zip(OUTPUTS, r0["scene"], scene_ref)}
    digest = [float(np.abs(o).astype(np.float64).sum()) for o in r0["scene"]]
    if not (all(a.shape == b.shape for a, b in zip(r0["scene"], scene_ref))
            and max(diffs.values()) <= 1e-4 and digest == r1["scene_digest"]):
        raise SystemExit(f"chip_smoke: parallel whole scene vs one process: {diffs}")

    # (4) the train CLI: both ranks' lines, rank 0's files only, the same parameters
    cli_ok = (all(f"distributed: process {r}/{PAR_WORLD}" in logs[r] for r in range(PAR_WORLD))
              and {"log_val.csv", "model-epoch0.pt"} <= set(r0["cli_files"])
              and r1["cli_files"] == []
              and all(torch.equal(v, r1["cli_params"][k]) for k, v in r0["cli_params"].items())
              and all(torch.isfinite(v.float()).all() for v in r0["cli_params"].values()))
    if not cli_ok:
        raise SystemExit(f"chip_smoke: parallel train CLI: files {r0['cli_files']} / "
                         f"{r1['cli_files']}\n{logs[0][-2000:]}")

    by_path = {}
    for path, part in (("parallel_train", "train"), ("parallel_chunked", "chunked"),
                       ("parallel_scene", "scene")):
        by_path[path] = {k: sum(r["rec"][part]["launches"][k] for r in res) for k in KERNELS}
    parts = {part: [dict(seconds=r["rec"][part]["seconds"],
                         max_memory_allocated=r["rec"][part]["max_memory_allocated"],
                         launches={k: v for k, v in r["rec"][part]["launches"].items() if v})
                    for r in res]
             for part in ("train", "chunked", "scene", "train_cli")}
    seconds = {k: [round(x["seconds"], 3) for x in v] for k, v in parts.items()}
    peaks = {k: [x["max_memory_allocated"] for x in v] for k, v in parts.items()}
    print(f"parallel: seconds by rank {seconds}; peak bytes by rank {peaks}; {smi}", flush=True)
    emit("parallel", world=PAR_WORLD, backend=r0["rec"]["backend"],
         devices=[r["rec"]["device"] for r in res], nvidia_smi=smi,
         note=("both ranks on one card: correctness figures, not scaling figures"
               if backend == "gloo" else "a card a rank"),
         ranks_seconds=ranks_seconds, single_process_train=single["train"], parts=parts,
         train=train_rec, chunked=chunk_rec, scene=dict(max_abs_diff=diffs),
         train_cli=dict(files_rank0=r0["cli_files"], files_rank1=r1["cli_files"]),
         launches_by_path=by_path)
    return by_path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke test of spsg_tpu_torch on one GPU.")
    ap.add_argument("--baseline-source", default=None,
                    help="another version of csrc/conv3x3.cu to time beside this one")
    ap.add_argument("--baseline-dw-source", default=None,
                    help="another version of csrc/conv3x3_dw.cu to time beside this one")
    ap.add_argument("--baseline-raycast-source", default=None,
                    help="another version of csrc/raycast.cu (the C interface of "
                         "ops/raycast.py::_bind) to time beside this one")
    ap.add_argument("--baseline-tsdf-source", default=None,
                    help="another version of csrc/tsdf.cu (spsg_tsdf_integrate, the whole "
                         "grid) to time beside this one")
    ap.add_argument("--parallel-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-ports", type=int, nargs=2, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-backend", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.parallel_rank is not None:  # one rank of the parallel phase, started by it
        parallel_rank(args.parallel_rank, *args.parallel_ports, args.parallel_dir,
                      args.parallel_backend)
        return
    import shutil

    par = tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=os.getcwd())
    try:
        run_phases(args, par)
    finally:
        shutil.rmtree(par, ignore_errors=True)


def run_phases(args, par):
    smi = phase_device()
    phase_build()
    for key, src in (("conv3x3", args.baseline_source),
                     ("conv3x3_dw", args.baseline_dw_source),
                     ("raycast", args.baseline_raycast_source),
                     ("tsdf", args.baseline_tsdf_source)):
        if src:
            BASELINE[key] = load_baseline(src, key)
    results = phase_compare()
    rc_results = phase_compare_raycast()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as tmp:
        serve = phase_path(tmp, par)
        scene = phase_scene(tmp, rc_results, par)
        phase_metrics(tmp, os.path.join(tmp, "scene"))
    train = phase_train()
    train2d, train2d_mc, train2d_device = phase_train2d()
    train2d_style = phase_train2d_style()
    train2d_bf16 = phase_train2d_bf16(train2d_device)
    forms = phase_conv_forms(par)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as tmp:
        train_cli = phase_train_cli(tmp, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as tmp:
        datagen, tsdf_rec = phase_datagen(tmp)
    parallel = phase_parallel(par, smi)

    # the kernels of each path: serving runs the two forward kernels, the 3D
    # training step all three conv kernels, the full step (with style / content
    # too) all but the occupancy march, which only the missing-colour weights
    # run; the train CLI as the full step (bf16 too); datagen the TSDF integrate
    training = tuple(k for k in KERNELS if k != "tsdf_integrate")
    full_step = tuple(k for k in training if k != "raycast_occ")
    on_path = {"serve": ("conv3x3", "conv3x3_act_stats"),
               "scene": ("conv3x3", "conv3x3_act_stats", "raycast_march", "raycast_shade"),
               "train": CONV_KERNELS,
               "train2d": full_step, "train2d_missing_colour": training,
               "train2d_style": full_step, "train2d_bf16": full_step, "train_cli": full_step,
               "datagen": ("tsdf_integrate",), **PAR_PATHS,
               **{path: (full_step if path.startswith("train2d") else
                         ("conv3x3", "conv3x3_act_stats")) for path in forms}}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        by_path = {"serve": serve[name], "scene": scene[name], "train": train[name],
                   "train2d": train2d[name],
                   "train2d_missing_colour": train2d_mc[name],
                   "train2d_style": train2d_style[name], "train2d_bf16": train2d_bf16[name],
                   "train_cli": train_cli[name], "datagen": datagen[name],
                   **{path: counts[name] for path, counts in parallel.items()},
                   **{path: counts[name] for path, counts in forms.items()}}
        for path, names in on_path.items():
            if name in names and by_path[path] < 1:
                raise SystemExit(f"chip_smoke: {name} was not launched on the {path} path")
        if name in CONV_KERNELS:
            recs = results[name]["float32"]
            head = next(r for r in recs if (r["shape"], r["cin"], r["cout"])
                        == (list(HEAVIEST[:4]), HEAVIEST[4], HEAVIEST[5]))
            measured_at = dict(shape=head["shape"], cin=head["cin"], cout=head["cout"],
                               dtype="float32")
            detail = dict(dtypes=results[name])
        elif name == "tsdf_integrate":
            recs = [tsdf_rec]
            head = tsdf_rec
            measured_at = dict(grid=head["grid"], image=head["image"], dtype="float32",
                               frames=len(head["frames"]))
            detail = dict(frames=head["frames"])
        else:
            recs = rc_results[name]
            # at the path's size, the grid with the most work: the prediction's, and
            # for the occupancy march the mask with the most samples
            path_recs = [r for r in recs if r["main_path"]]
            head = (max((r for r in path_recs if r["grid"] in OCC_STEP_GRIDS),
                        key=lambda r: r["samples"]) if name == "raycast_occ"
                    else next(r for r in path_recs if r["grid"] == "prediction"))
            measured_at = dict(grid=head["grid"], dims=head["dims"], image=head["image"],
                               dtype="float32")
            detail = dict(cases=recs)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            measured_at=measured_at, **detail))
    print(smi, flush=True)  # again, so that it stands near the result whatever was printed above
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

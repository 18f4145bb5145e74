#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (spsg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device, nvcc, and nothing else (no network, no dataset:
everything is made from seeds, but phase "trained", which reads the JAX
package's trained weights and golden files committed under docs/evidence).
It exits with a code other than 0, and without its last line, if there is no
CUDA device or if any phase fails. Phases, each printing one JSON line:

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
           first the arithmetic of ops/xla_arith.py (XLA's float32 forms, in
           plain tensor ops) on the card against the CPU, to the bit: fma32 on
           2^20 seeded triples and on triples made to lie just off a float32
           halfway point (where a float64 sum then a cast rounds wrong), exp32,
           sqrt32, div_const, block_sum; the ray set-up (K12) and the depth
           chain (K9-K11) at the path's shape against the CPU's plain versions;
           their device times (with --baseline-port-source beside the older
           modules'). Then K12 and K9-K11 against their plain versions run on
           the card, to the bit: the set-up on the valid voxels of the step's
           input, target and noisy prediction grids, an empty grid and a
           camera whose rays have a component within 1e-9 of 0; the bilateral
           filter, one median round and the normals on the step's frames,
           frames without holes beside frames with them, frames whose holes
           the fill cannot close (the loop runs to max_iters), frames of holes
           but for one pixel, frames of millimetre ties, a checkerboard of
           holes (a round that read its own writes would differ) and frames
           of negative depths and NaN pixels of either sign (a wrong key
           order would differ); the fill as a whole on the same frames (filled
           depth and all_valid, the plain loop's host reads, the holes of each
           round that ran, K9's and K10's launches a fill, the fill's bound);
           per kernel device time, plain time, bound (bytes, or the float32
           operations its inputs need at 67 TFLOP/s), no library yardstick;
           with --baseline-port-source K9, a K10 round, K11 and the fill of
           the older depth.py timed in turns with these on the step's frames,
           the older K12 on every set-up case, and the older fill's launches;
           the chain (depth_to_normals: K9, then the fill's launch with K11 as
           its last phase) against the plain chain run on the card, to the bit,
           on every frame case, its launches and device time; the operations
           that a set-up and a chain put on the stream (torch.profiler), with
           --baseline-port-source the older ones' too and the chain in turns.
           Then
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
           reference (.pth, its module names): launches K1 5, K3 23, K4 3, K5 3, K12 3;
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
           dx, 25 dW, 7 library convs' dW (libconv_dw); geometry-only flags: 9,
           2 + 11, 11, 3); three more steps
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
           the colour head; K4 3, K5 3, K6 1, K12 3, K9 1, K10 1 (one
           cooperative launch runs every round of the fill), K11 1 (run as
           the last phase of that launch), libconv_dw 7) and the
           depth chain's host reads (0 on the kernels);
           one step against a twin with the plain convs and the plain raycaster
           (metrics, every parameter gradient of the generator; the
           discriminator's reported; prediction pixels whose hit differs, counted); one warm-up
           and three timed steps (median seconds, peak memory); a validation pass
           changes nothing; device time of one step by kind; one full step with
           weight_missing_color 2 (launches as above and K7 2) against its
           plain twin, and precompute_views on the same batch identical to the
           bit to what that step computed (hits, normals, frames_ok, masks);
           a 16^3 / nf 4 / 48x32 full step on the GPU against the same step
           on the CPU. The plain twin takes the plain raycaster, set-up and
           depth chain (plain_raycast_inside)
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
           float32): the launches as in train2d but libconv_dw 0 (the library
           convs in bf16 keep cuDNN's dW), every block's conv through the
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
           kernel once more in the backward; libconv_dw 7, 0 with zslab_conv, 5
           with folded_conv), metrics within 1e-4 relative (2D
           and adversarial 1e-3) and the generator's gradients held to the
           gradient rule against the default step (Tolerances, below),
           one warm-up and three timed steps (median seconds, peak memory) and
           device time by kind; the generator alone with and without remat on
           the card, and without it twice (outputs, running statistics and
           gradients identical to the bit or not); the gradient rule's witness on
           three seeds (weights and batch): the full step with the seven library
           convs in float64 (with the kernels, and with the plain convs and
           raycaster: the two yardsticks), the default step twice, the plain
           twin, the step with each flag and two seeded faults (a wrong weight
           tap in encoder_1a's z-slab conv; a wrong tap in K2's first output of
           the step): the kernels against the plain twin and each flag against
           the default step pass the rule, both faults fail it, on every seed,
           and on each seed a fault fails the 1e-2 rule too (both faults'
           readings printed); reported as before: each step's generator
           gradients against the float64 step's per leaf (the worst leaves, the
           readings on the leaf that is worst between zslab_conv and the
           default) and the LeakyReLU slope flips of each forward against the
           float64 step's; the scene phase's whole
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
           as train2d's twin, 1e-4 / 1e-3 relative; the generator's gradients by
           the gradient rule, the one-process default step the reference, also
           on the witness's seeds 1 and 2; the discriminator's within 1e-4), the
           ranks' metrics,
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
  trained  the JAX package's trained nf 20 model (bench_r4's model-epoch59) from
           docs/evidence/torch_port/epoch59 (tools/export_torch_goldens.py; each
           file's sha256 against MANIFEST.json): the chunked CLI with its .pt on
           the golden's (128,160,192) scene, float32, against the JAX package's
           golden_chunked.npz (overlap counts, occupancy and labels on >= 99.9 %
           of the voxels, SDF within 1e-3 and colour within 1 where both
           predict, IoU and mIoU within 0.005, class weights equal), the same in
           bf16 against float32 (reported); the whole-scene CLI with the .pt
           (seconds, device time by kind, K4's lattice samples, samples in
           occupied blocks and samples loaded per ray of the prediction's
           render, beside the scene phase's seeded-weight figures; K4 / K5
           against their plain versions on it), a bf16 scene against float32
           (as the scene phase); the validation pass of golden_val.json's 8
           chunks (their frames rendered on the CPU, each frame's sha256 against
           the golden's, reported) on the card's own views, whose marches hash
           to the golden's and which hold the JAX value at each index of the
           golden's march_patches (nothing patched in), against the JAX
           package's metrics per chunk and mean (3D 1e-4 relative, 2D and
           adversarial 1e-3); the JAX
           package's style run (bench_r5's args.txt: batch 8, bf16, style /
           content 0.01, geometry-only 1, before-content 1, from the .pt at
           epoch 60) through the train CLI in this process, its 64 synthetic
           chunks, cut to 2 epochs, in bf16, float32 and float32 with --remat:
           seconds per iteration by kind, peak memory, launches, every loss
           finite, the first validation's metrics within the golden's range
           over its chunks; the full step's peak memory at batch 2, 4 and 8
           with and without remat, a line through each mode's peaks predicting
           the largest batch under 90 % of the card's memory, that batch run
           once in each mode; max_dilation 2 on seeded weights: one window
           batch against its plain-conv twin (1e-3; 27 launches, geo_1d off
           K1 / K3) and one full step against its plain twin (launches K3 22,
           K1 32, K2 27, libconv_dw 7; metrics as train2d's, gradients by the gradient rule)
  libconv_dw
           the library convs' weight gradient (ops/libconv_dw.py,
           libconv_dw_kernel + libconv_dw_join_kernel in csrc/conv3x3_dw.cu):
           every variant of libconv_dw_kernel has HMMA in its machine code; at
           each of the generator's seven library convs (nf 20, (128,64,64)
           chunks) at batch 2 and 8, the kernel against
           torch.nn.grad.conv3d_weight in true float32 (within 1e-4 of
           max|dW|) and, at batch 2, in float64 (reported), two calls bit-equal, its time
           beside cuDNN's float32 wgrad and the 3xTF32 bound; the same checks
           on shapes off the path (ragged tiles, a tail chunk of channels, Cout
           split over blocks, 3^3 stride 2, inputs at an odd address); then the
           generator's train forward and backward at batch 2, with and without
           remat: kernel launches equal to the counter train.libconv_dw (7)
  kernels  one line {"kernels": [...]}: per kernel its launches on the
           paths (serve, scene, train, train2d, train2d_missing_colour,
           train2d_style, train2d_bf16, train_cli, datagen, parallel_train,
           parallel_chunked, parallel_scene (both ranks' counts added),
           train2d_zslab_conv, train2d_folded_conv, train2d_remat,
           scene_zslab_conv, scene_folded_conv, trained_chunked, trained_scene,
           trained_validation, trained_style_bfloat16, trained_style_float32,
           trained_style_remat, trained_largest_batch,
           trained_largest_batch_remat, dilation2_window, dilation2_step;
           each counter set to 0 just before the path's run and read just
           after; with --phases, the paths that ran) and its numbers at the
           heaviest main-path shape (for the raycaster's, the prediction grid
           at the path's size; for K7 the
           mask with the most samples; for K8 the mean of 8 of the room scan's
           frames; for libconv_dw the seven library convs summed at batch 2),
           with every shape (and, for the convs,
           both storage types) nested inside
  last     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Options (none when the script is run as the check of a checkout):
  --phases NAME,...  only these phases (and those whose outputs they read:
           metrics and conv_forms take scene, parallel takes path and scene);
           device and build always run; the kernels line lists the launches of
           the paths that ran, and a kernel's times only if its compare phase
           (compare, compare_raycast, datagen, libconv_dw) ran
  --baseline-source PATH  another version of csrc/conv3x3.cu (e.g. the parent
           commit's, unpacked with git archive): built beside this one, and its
           K1 / K3 timed at every shape in turns with this one (baseline, this,
           this, baseline) through the same wrapper; "baseline_ms" per record
  --baseline-dw-source PATH  the same for csrc/conv3x3_dw.cu and K2
  --baseline-raycast-source PATH  the same for csrc/raycast.cu, K4, K5, K6 and
           K7 (a version with the C interface ops/raycast.py::_bind declares,
           K4-K6 and a hopping K7 (spsg_raycast_occ_hop) run through the same
           wrappers; an older K7, which walks every sample, through its own
           entry spsg_raycast_occ), at the path's shape; "baseline_ms" per
           record
  --baseline-port-source DIR  another version's spsg_tpu_torch/ops directory
           (its raycast.py and depth.py, e.g. the parent commit's): its ray
           set-up and depth chain timed in turns with this one's at the path's
           shape (compare_raycast's "xla_arith" record, "baseline_ms")
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
relative (also GPU against CPU at 16^3), the generator's gradients by the
gradient rule (grad_rule): each step is measured from a yardstick, the
reference step (the plain twin, or the default step) with its seven library
convs in float64; per leaf d(step, yardstick) = max difference over the
yardstick's largest entry; the candidate's d at most 3 times the reference's or
3e-2 (3 times a floor of 1e-2) on every leaf, and its median leaf at most 3 times
the reference's median. Two float32 forwards differ by rounding, which gives a
few hundred of the 3.1e8 activations of the full step, those within rounding of
0, the other LeakyReLU slope, and one flip moves some leaf by ~1e-2 (the
gradient witness of conv_forms): a leaf-by-leaf rule between two float32 steps
(1e-2, the earlier rule) was a lottery over seeds. Full
step against its twin, and GPU against CPU: the 3D metrics within 1e-4 relative,
the 2D and adversarial ones within 1e-3 (a prediction pixel whose hit flips
between two float32 forwards moves a mean over a few thousand pixels by ~1e-4);
against its twin also the generator's gradients by the gradient rule, as in the
train step; the discriminator's are reported only
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
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

if __name__ == "__main__" and not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device",
          file=sys.stderr)
    sys.exit(2)

import torch.nn.functional as F  # noqa: E402

from spsg_tpu_torch.cli import test_scene_as_chunks as cli  # noqa: E402
from spsg_tpu_torch.datagen import fusion as tsdf  # noqa: E402
from spsg_tpu_torch.inference import chunked  # noqa: E402
from spsg_tpu_torch.losses import geo as geo_losses  # noqa: E402
from spsg_tpu_torch.models import convert  # noqa: E402
from spsg_tpu_torch.models import generator as tg_models  # noqa: E402
from spsg_tpu_torch.models.generator import ConvBlock, use_true_float32  # noqa: E402
from spsg_tpu_torch.ops import _build, conv3x3 as conv_ops  # noqa: E402
from spsg_tpu_torch.ops import libconv_dw as libconv_ops  # noqa: E402
from spsg_tpu_torch.ops.folded_conv import conv_folded, pick_fold  # noqa: E402
from spsg_tpu_torch.ops.zslab_conv import conv3d_zslab  # noqa: E402
from spsg_tpu_torch.ops import depth as depth_ops, normals3d, raycast as rc_ops  # noqa: E402
from spsg_tpu_torch.training import StepFlags, TrainConfig  # noqa: E402
from spsg_tpu_torch.training import state  # noqa: E402
from spsg_tpu_torch.training.step import Trainer  # noqa: E402
from spsg_tpu_torch.utils import goldens, timing  # noqa: E402

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
    # the ray set-up of find_surface_crossings (:436-447; _camera_rays :127, _ray_aabb
    # :236, _valid_bounds :253) and of raycast_occ (:905-934), for K4 and K7
    "raycast_setup": ("spsg_tpu_torch/ops/csrc/raycast.cu", "spsg_tpu/ops/raycast.py:436"),
    # the depth chain of spsg_tpu/ops/depth.py (XLA): bilateral_filter, a round of
    # median_fill (and fill_depth_holes' loop around it), depth_to_camera_space with
    # camera_space_normals (:103, :121)
    "depth_bilateral": ("spsg_tpu_torch/ops/csrc/depth.cu", "spsg_tpu/ops/depth.py:34"),
    "depth_median_round": ("spsg_tpu_torch/ops/csrc/depth.cu", "spsg_tpu/ops/depth.py:56"),
    "depth_normals": ("spsg_tpu_torch/ops/csrc/depth.cu", "spsg_tpu/ops/depth.py:103"),
    # the TSDF integrate of dataset generation (spsg_tpu/datagen/fusion.py, XLA)
    "tsdf_integrate": ("spsg_tpu_torch/ops/csrc/tsdf.cu", "spsg_tpu/datagen/fusion.py:77"),
    # the weight gradient of the generator's library convs (XLA's, of the nn.Conv
    # of spsg_tpu/models/generator.py::ConvBlock; no Pallas kernel)
    "libconv_dw": ("spsg_tpu_torch/ops/csrc/conv3x3_dw.cu", "spsg_tpu/models/generator.py:367"),
}
CONV_KERNELS = ("conv3x3", "conv3x3_act_stats", "conv3x3_dw")
RAYCAST_KERNELS = ("raycast_march", "raycast_shade", "raycast_scatter", "raycast_occ")
DEPTH_KERNELS = ("depth_bilateral", "depth_median_round", "depth_normals")
# the kernels of the set-up and the depth chain (compare_setup_depth)
SETUP_DEPTH_KERNELS = ("raycast_setup",) + DEPTH_KERNELS
# none of them runs on a path: the counters' zeros
NO_SETUP_DEPTH = {k: 0 for k in SETUP_DEPTH_KERNELS}
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
    return {**conv_ops.launch_counts, **rc_ops.launch_counts, **tsdf.launch_counts,
            **depth_ops.launch_counts, **libconv_ops.launch_counts}


def reset_all_launch_counts():
    conv_ops.reset_launch_counts()
    libconv_ops.reset_launch_counts()
    rc_ops.reset_launch_counts()
    tsdf.reset_launch_counts()
    depth_ops.reset_launch_counts()


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


def _op_name(key):
    key = key.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?([\w:<>, ]+?)\s*\(", key)
    return m.group(1) if m else key[:60]


def stream_ops(fn, reps=4):
    """The operations one call of ``fn`` puts on the card's stream (kernels,
    memsets, copies; torch.profiler's device activities), by name, and their
    total: counted over ``reps`` calls after a warm-up step of the profiler
    (whose first events it may drop), per call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=reps)) as prof:
        for _ in range(reps + 2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    ops = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = _op_name(e.key)
            ops[name] = ops.get(name, 0) + e.count / reps
    return dict(total=sum(ops.values()), by_name=ops)


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
        # the wrapper as the step calls it: the ray set-up (K12), then K7
        rec["ms_with_setup"] = device_ms(lambda: rc_ops.raycast_occ(occ, view, intr, cfg), 20)
        # how often the wrapper waits for the card (torch's sync debug mode warns
        # once for each operation that does; its other warning, that the mode is a
        # prototype, is not counted): never, since the set-up is K12 and K7's map
        # is its own launch
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
    if lib is not None and hasattr(lib, "spsg_raycast_occ_hop"):
        # a hopping K7 (PR 13 on): through the package's wrapper, as K4-K6
        rec["baseline_pixels_differing"] = int((on_raycast_library(fn, lib)() != ref).sum())
        if on_path:
            baseline = on_raycast_library(fn, lib)
    elif lib is not None and hasattr(lib, "spsg_raycast_occ"):
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


def halfway_triples():
    """float32 triples whose a * b + c lies just off a float32 halfway point,
    so close that the float64 sum rounds onto it: a float64 sum then a cast
    rounds them the wrong way (ties to even), an FMA does not. Scaled by
    powers of two and of either sign."""
    a, b, c = 1 + 2.0 ** -18, (1 - 2.0 ** -18) * 2.0 ** -24, 1 + 2.0 ** -23
    rows = [(a * sg * 2.0 ** k, b, c * sg * 2.0 ** k) for k in (-20, -3, 0, 5, 30)
            for sg in (1.0, -1.0)]
    return torch.tensor(rows, dtype=torch.float32).T.contiguous()


def profiled_device_ms(fn):
    """Device time of one call of ``fn`` from the profiler's kernel records
    (for a function that reads flags back to the host, which device_ms cannot
    queue behind a spin), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(device_time_by_kind(prof, {})[0].values()) / 1e3


def load_baseline_port(src):
    """ops/raycast.py and ops/depth.py of another version of the package
    (``src``: its spsg_tpu_torch/ops directory, e.g. the parent commit's
    unpacked with git archive), imported as the package ``baseline_ops``."""
    import importlib.util
    import types

    pkg = types.ModuleType("baseline_ops")
    pkg.__path__ = [os.path.abspath(src)]
    sys.modules["baseline_ops"] = pkg
    mods = {}
    for name in ("raycast", "depth"):
        spec = importlib.util.spec_from_file_location(f"baseline_ops.{name}",
                                                      os.path.join(src, f"{name}.py"))
        mods[name] = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mods[name]
        spec.loader.exec_module(mods[name])
    emit("baseline", module="ops/raycast.py, ops/depth.py", source=src)
    return mods


def path_batch():
    """The make_chunk_batch (2 chunks, frames rendered on the card) that
    compare_xla_arith and compare_setup_depth take at the training path's
    shape."""
    from spsg_tpu_torch.data import synthetic

    dims, image = RC_SHAPES[1][:2]
    return synthetic.make_chunk_batch(2, dims, image, seed=11, with_frames=True, device=DEV)


def compare_xla_arith(bt):
    """ops/xla_arith.py on the card against the CPU, to the bit: fma32 on 2^20
    seeded float32 triples (12 decades of exponents, a third of the sums
    cancelling) and on the triples of :func:`halfway_triples`, exp32 over its
    range and the clamps, sqrt32, block_sum of 81 and 121 terms; and what is
    built of them, at the training path's shape ((128,64,64), 320x256, batch
    2): the ray set-up (march_setup, on the input grid) and the depth chain
    (depth_to_normals on the frames, their holes filled), on the card by K12
    and K9-K11, on the CPU by the plain versions. Device times of
    the set-up (a call; the step makes 3) and of the depth chain (the
    profiler's kernel time of a call), and with --baseline-port-source those
    of the older modules in turns (baseline, this, this, baseline)."""
    from spsg_tpu_torch.ops import xla_arith

    g = torch.Generator().manual_seed(17)
    n = 1 << 20
    a, b, c = (torch.randn(n, generator=g) * 10.0 ** torch.randint(-6, 7, (n,), generator=g)
               for _ in range(3))
    c[::3] = -(a[::3].double() * b[::3]).float() * (1 + 1e-6 * torch.randn(c[::3].shape,
                                                                             generator=g))
    half = halfway_triples()
    a, b, c = (torch.cat([v, h]) for v, h in zip((a, b, c), half))
    bits = (lambda t: t.float().contiguous().cpu().view(torch.int32))
    cases = {
        "fma32": lambda d: xla_arith.fma32(a.to(d), b.to(d), c.to(d)),
        "exp32": lambda d: xla_arith.exp32(torch.linspace(-100.0, 100.0, n).to(d)),
        "sqrt32": lambda d: xla_arith.sqrt32(a.abs().to(d)),
        "div_const": lambda d: xla_arith.div_const(a.to(d), 0.9),
        "block_sum_81": lambda d: xla_arith.block_sum(list(a[:81 * 4096].reshape(81, 4096).to(d))),
        "block_sum_121": lambda d: xla_arith.block_sum(
            list(a[:121 * 4096].reshape(121, 4096).to(d))),
    }
    rec = {k: int((bits(f(DEV)) != bits(f("cpu"))).sum()) for k, f in cases.items()}
    naive = (half[0].double() * half[1] + half[2]).float()
    rec["halfway_fma32_not_naive"] = int(
        (bits(xla_arith.fma32(*half.to(DEV))) != bits(naive)).sum())
    if rec["halfway_fma32_not_naive"] != half.shape[1]:
        raise SystemExit(f"chip_smoke: xla_arith: fma32 rounds the halfway triples as a float64 "
                         f"sum does: {rec}")

    image = RC_SHAPES[1][1]
    valid = to_dev(np.abs(bt["input"][..., 0]) < 3.0)
    view, intr = to_dev(bt["images_view"]), to_dev(bt["images_intrinsic"])
    depth = to_dev(bt["images_depth"])
    cfg = rc_ops.RaycastConfig(width=image[0], height=image[1])
    setup_dev = rc_ops.march_setup(valid, view, intr, cfg)
    setup_cpu = rc_ops.march_setup(valid.cpu(), view.cpu(), intr.cpu(), cfg)
    rec["march_setup"] = sum(int((bits(x) != bits(y)).sum()) for x, y in zip(setup_dev, setup_cpu))
    chain_dev = depth_ops.depth_to_normals(depth, intr, 40)
    chain_cpu = depth_ops.depth_to_normals(depth.cpu(), intr.cpu(), 40)
    rec["depth_to_normals"] = sum(int((bits(x) != bits(y)).sum())
                                  for x, y in zip(chain_dev, chain_cpu))
    rec["frame_holes"] = int((depth == 0).sum())
    if (any(rec[k] for k in list(cases) + ["march_setup", "depth_to_normals"])
            or not rec["frame_holes"]):
        raise SystemExit(f"chip_smoke: xla_arith: the card's bits are not the CPU's: {rec}")

    setup_fn = (lambda: rc_ops.march_setup(valid, view, intr, cfg))
    chain_fn = (lambda: depth_ops.depth_to_normals(depth, intr, 40))
    times = dict(setup={}, depth_chain={})
    if "port" in BASELINE:
        old = BASELINE["port"]
        old_cfg = old["raycast"].RaycastConfig(width=image[0], height=image[1])
        time_in_turns(setup_fn, lambda: old["raycast"].march_setup(valid, view, intr, old_cfg),
                      20, times["setup"])
        turns = [profiled_device_ms(lambda: old["depth"].depth_to_normals(depth, intr, 40)),
                 profiled_device_ms(chain_fn), profiled_device_ms(chain_fn),
                 profiled_device_ms(lambda: old["depth"].depth_to_normals(depth, intr, 40))]
        times["depth_chain"].update(ms=(turns[1] + turns[2]) / 2,
                                    baseline_ms=(turns[0] + turns[3]) / 2, ms_turns=turns)
    else:
        time_in_turns(setup_fn, None, 20, times["setup"])
        times["depth_chain"]["ms"] = profiled_device_ms(chain_fn)
    rec["device_ms"] = times
    return rec


# float32 operations the bounds of K9-K12 count: a bilateral tap whose neighbour
# is valid (d, d * -d, the scale, exp32's ~20, the weight, its product, two
# sums); a pixel's normal (five unprojections, differences, cross product,
# norm, three divisions); a ray of the set-up (camera ray, rotation, two
# norms, six divisions, the slab test, skip, t0, t_stop)
BILATERAL_TAP_FLOPS = 28
NORMAL_FLOPS = 60
SETUP_RAY_FLOPS = 70


def depth_cases(depth):
    """Frames (2, 256, 320) made to catch a fault in K9-K11 and the fill loop,
    beside the step's own frames (``depth``, rendered with holes): a frame
    without holes beside one with holes; frames whose holes cannot all be
    filled (a 300-pixel-wide hole, which the fill closes 5 pixels a round, so
    the loop runs to max_iters, beside a frame of holes only); a frame of
    holes but for one pixel; frames of millimetre ties (four depths 1 mm apart
    and 35 % holes); the step's frames with a checkerboard of holes over rows
    20-235 (each hole's diagonal neighbours are holes: a round that read a
    value it wrote would fill them from each other); the step's frames with
    rows 40-79 negated (3 % of them -inf, 60 % of a patch, where windows'
    medians are -inf; windows of negative millimetres only, whose keys' low
    bits are ones) and NaN pixels of either sign, 8 % of the frame and 60 % of
    a band (rows 120-159, where windows' medians fall among their NaNs: a key
    that does not put every NaN after +inf selects another value)."""
    g = torch.Generator().manual_seed(23)
    filled = depth_ops.fill_depth_holes_plain(depth, 40)[0][0]
    slow = depth.clone()
    slow[0, :, :300] = 0.0
    slow[1] = 0.0
    one = depth.clone()
    one[0] = 0.0
    one[0, 100, 200] = 2.0
    ties = (1.0 + 0.001 * torch.randint(0, 4, depth.shape, generator=g)).to(DEV)
    ties[(torch.rand(depth.shape, generator=g) < 0.35).to(DEV)] = 0.0
    yy, xx = torch.meshgrid(torch.arange(depth.shape[1]), torch.arange(depth.shape[2]),
                            indexing="ij")
    board = depth.clone()
    board[:, (((yy + xx) % 2 == 0) & (yy >= 20) & (yy < 236)).to(DEV)] = 0.0
    odd = depth.clone()
    odd[:, 40:80] *= -1.0
    odd[:, 40:80][(torch.rand((depth.shape[0], 40, depth.shape[2]), generator=g)
                   < 0.03).to(DEV)] = -float("inf")
    odd[:, 50:60, 100:130][(torch.rand((depth.shape[0], 10, 30), generator=g)
                            < 0.6).to(DEV)] = -float("inf")
    nan = torch.rand(depth.shape, generator=g) < 0.08
    nan[:, 120:160] = torch.rand((depth.shape[0], 40, depth.shape[2]), generator=g) < 0.6
    negative = nan & (torch.rand(depth.shape, generator=g) < 0.5)
    odd[nan.to(DEV)] = float("nan")
    odd[negative.to(DEV)] = -float("nan")
    return {"step": depth,
            "no_holes_beside_holes": torch.stack([torch.where(filled == 0, 1.0, filled),
                                                  depth[1]]),
            "unfillable": slow, "all_holes_but_one": one, "millimetre_ties": ties,
            "checkerboard": board, "negative_nan": odd}


def fill_round_holes(d, max_iters=40):
    """The holes of the frames with holes that each round of the plain fill
    meets (round 0 on the filtered frames, then each round the loop runs):
    what a fill's selections must read, for its bound."""
    had = (d == 0).reshape(d.shape[0], -1).any(dim=-1)[:, None, None]
    if not bool(had.any()):
        return []
    cur = depth_ops.bilateral_filter_plain(d)
    holes = [int(((cur == 0) & had).sum())]
    cur = depth_ops.median_fill_plain(cur)
    while len(holes) <= max_iters and bool(((cur == 0) & had).any()):
        holes.append(int(((cur == 0) & had).sum()))
        cur = depth_ops.median_fill_plain(cur)
    return holes


def fill_launches(module, d):
    """Launches of each kernel of ``module``'s (an ops/depth.py) one fill of ``d``."""
    module.reset_launch_counts()
    module.fill_depth_holes(d, 40)
    counts = dict(module.launch_counts)
    module.reset_launch_counts()
    return counts


def setup_cases(bt, view, intr):
    """(valid, view, intrinsics) of K12's cases: the valid voxels of the
    step's three grids (input, target, a noisy prediction: |sdf| < 3) under
    the step's cameras, an empty grid, and a camera along +z turned by 5e-10
    rad about y, whose centre column's rays have a direction x within 1e-9 of
    0 (the slab test's 1e12 branch)."""
    tgt = np.clip(bt["target_sdf"], -3.0, 3.0)
    noise = np.random.default_rng(11).normal(0, 0.5, tgt.shape).astype(np.float32)
    grids = {"input": bt["input"][..., 0], "target": tgt, "prediction": tgt + noise}
    cases = {k: (to_dev(np.abs(g) < 3.0), view, intr) for k, g in grids.items()}
    cases["empty"] = (torch.zeros_like(cases["input"][0]), view, intr)
    a = 5e-10
    turned = torch.tensor([[np.cos(a), 0, np.sin(a), 32.0], [0, 1, 0, 32.0],
                           [-np.sin(a), 0, np.cos(a), -40.0], [0, 0, 0, 1]],
                          dtype=torch.float32).repeat(2, 1, 1).to(DEV)
    near = torch.tensor([[277.0, 277.0, 160.0, 128.0]] * 2, dtype=torch.float32, device=DEV)
    cases["near_axis"] = (cases["input"][0], turned, near)
    return cases


def bits_differing(got, want):
    return sum(int((as_bits(g) != as_bits(w)).sum()) for g, w in zip(got, want))


def kernel_record(case, shape, on_path, fn, plain, t_bytes, t_ops, reps=20):
    """A record of compare_setup_depth: device times of the kernel and of its
    plain version on the card (neither reads back to the host), the bound."""
    return dict(case=case, shape=list(shape), main_path=on_path, max_abs_err=0.0,
                ms=device_ms(fn, reps), plain_ms=device_ms(plain, 3), library_ms=None,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def compare_setup_depth(bt):
    """K12 and K9-K11 (with the fill loop) against their plain versions run on
    the card, to the bit, at the training path's shape ((128,64,64) grids,
    2 frames of 320x256; ``bt`` the make_chunk_batch of compare_xla_arith) on
    the cases of setup_cases and depth_cases; per kernel and case its device
    time, its plain version's, its bound (no library call computes the same
    function: "library_ms" None). The fill (K9, then every round of K10 in one
    cooperative launch) is held as a whole too, its plain loop's host reads
    counted (on "unfillable" the plain loop runs to max_iters: 41 reads), its
    launches, bound and time beside the plain loop's on the step's frames.
    With --baseline-port-source, K9, a K10 round, K11 and the fill of the
    older depth.py are timed in turns with these on the step's frames, and the
    older K12 on every set-up case. The chain (depth_to_normals: K9, then the
    fill's launch with K11 as its last phase) is held to the bit against the
    plain chain on every case, its launches counted; on the step's frames the
    operations a chain and a set-up put on the stream are counted (the
    profiler), and with --baseline-port-source the older chain's, and the
    chain is timed in turns with it. K9 and K10 at other radii (their generic
    instantiations) are held to the bit too."""
    results = {k: [] for k in SETUP_DEPTH_KERNELS}
    view, intr = to_dev(bt["images_view"]), to_dev(bt["images_intrinsic"])
    image = (bt["images_depth"].shape[2], bt["images_depth"].shape[1])
    cfg = rc_ops.RaycastConfig(width=image[0], height=image[1])
    old_rc = BASELINE["port"]["raycast"] if "port" in BASELINE else None
    old_cfg = old_rc and old_rc.RaycastConfig(width=image[0], height=image[1])
    for name, (valid, cview, cintr) in setup_cases(bt, view, intr).items():
        fn = (lambda: rc_ops.march_setup(valid, cview, cintr, cfg))
        plain = (lambda: rc_ops.march_setup_plain(valid, cview, cintr, cfg))
        diff = bits_differing(fn(), plain())
        if diff:
            raise SystemExit(f"chip_smoke: raycast_setup {name}: {diff} elements differ from "
                             f"march_setup_plain")
        B, n_ray = valid.shape[0], cfg.width * cfg.height
        t_bytes = (valid.numel() + B * (64 + 16 + 12) + B * n_ray * 24) / PEAK_BYTES
        rec = kernel_record(name, valid.shape, name == "input", fn, plain, t_bytes,
                            B * n_ray * SETUP_RAY_FLOPS / F32_FLOPS)
        if name == "near_axis":
            rec["rays_within_1e-9"] = int((fn().direction.abs() <= 1e-9).sum())
            if not rec["rays_within_1e-9"]:
                raise SystemExit("chip_smoke: raycast_setup near_axis: no ray component "
                                 "within 1e-9 of 0")
        if name == "input":  # what a set-up puts on the stream
            rec["stream_ops"] = stream_ops(fn)
        if old_rc is not None:  # the older set-up in turns with this one, on every case
            old_fn = (lambda: old_rc.march_setup(valid, cview, cintr, old_cfg))
            if name == "input":
                rec["baseline_stream_ops"] = stream_ops(old_fn)
            time_in_turns(fn, old_fn, 20, rec)
        results["raycast_setup"].append(rec)
    depth = to_dev(bt["images_depth"])
    old = BASELINE["port"]["depth"] if "port" in BASELINE else None
    fill_recs = []
    for name, d in depth_cases(depth).items():
        on_path = name == "step"
        B, Hh, W = d.shape
        n_px, valid = d.numel(), (d != 0).float()
        k9 = torch.ones((1, 1, 9, 9), device=DEV)
        pairs = int((F.conv2d(valid[:, None], k9, padding=4)[:, 0] * valid).sum())
        checks = {
            "depth_bilateral": (lambda: depth_ops.bilateral_filter(d),
                                lambda: depth_ops.bilateral_filter_plain(d),
                                2 * n_px * 4, pairs * BILATERAL_TAP_FLOPS,
                                old and (lambda: old.bilateral_filter(d))),
            "depth_median_round": (lambda: depth_ops.median_fill(d),
                                   lambda: depth_ops.median_fill_plain(d),
                                   2 * n_px * 4, int((d == 0).sum()) * 121,
                                   old and (lambda: old.median_fill(d))),
            "depth_normals": (lambda: depth_ops.unproject_normals(d, intr),
                              lambda: depth_ops.unproject_normals_plain(d, intr),
                              n_px * (4 + 12) + B * 16, B * (Hh - 2) * (W - 2) * NORMAL_FLOPS,
                              old and (lambda: old.unproject_normals(d, intr))),
        }
        for kname, (fn, plain, nbytes, flops, old_fn) in checks.items():
            diff = bits_differing([fn()], [plain()])
            if diff:
                raise SystemExit(f"chip_smoke: {kname} {name}: {diff} elements differ from "
                                 f"its plain version")
            rec = kernel_record(name, d.shape, on_path, fn, plain, nbytes / PEAK_BYTES,
                                flops / F32_FLOPS)
            rec["holes"] = int((d == 0).sum())
            if on_path and old_fn is not None:  # the older kernel in turns with this one
                time_in_turns(fn, old_fn, 20, rec)
            results[kname].append(rec)
        # the fill as a whole: the kernels' schedule against the plain loop
        depth_ops.reset_host_syncs()
        want = depth_ops.fill_depth_holes_plain(d, 40)
        reads = depth_ops.host_syncs["fill_depth_holes"]
        got = depth_ops.fill_depth_holes(d, 40)
        diff = bits_differing(got, want)
        if diff or (name == "unfillable" and reads != 41):
            raise SystemExit(f"chip_smoke: fill_depth_holes {name}: {diff} elements differ "
                             f"from the plain loop (its host reads: {reads})")
        # the bound: the frames read once and written once, 121 compares a hole a
        # round that runs (the same count for any version of the fill)
        holes = fill_round_holes(d)
        t_bytes, t_ops = (2 * n_px * 4 + B) / PEAK_BYTES, sum(holes) * 121 / F32_FLOPS
        fill_fn = (lambda: depth_ops.fill_depth_holes(d, 40))
        rec = dict(case=name, plain_loop_host_reads=reads,
                   frames_all_valid=[bool(v) for v in got[1]],
                   holes_left=int((got[0] == 0).sum()), holes_by_round=holes,
                   rounds=len(holes), launches_a_fill=fill_launches(depth_ops, d),
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   ms=device_ms(fill_fn, 10),
                   # the plain loop's time on the step's frames only: a profile of its
                   # thousands of launches takes seconds
                   plain_ms=profiled_device_ms(
                       lambda: depth_ops.fill_depth_holes_plain(d, 40))
                   if on_path else "not measured")
        if on_path:
            rec["ptxas"] = [k for k in _build.ptxas_summary("depth")
                            if "bilateral" in k["kernel"] or "fill" in k["kernel"]
                            or "median" in k["kernel"]]
            if old is not None:
                rec["baseline_launches_a_fill"] = fill_launches(old, d)
                time_in_turns(fill_fn, lambda: old.fill_depth_holes(d, 40), 10, rec)
        # the chain (depth_to_normals: on the card K9 and the fill with K11 as its
        # last phase) against the plain chain run on the card, to the bit
        chain_fn = (lambda: depth_ops.depth_to_normals(d, intr, 40))
        diff = bits_differing(chain_fn(), depth_ops.depth_to_normals_plain(d, intr, 40))
        if diff:
            raise SystemExit(f"chip_smoke: depth_to_normals {name}: {diff} elements differ "
                             f"from the plain chain")
        depth_ops.reset_launch_counts()
        chain_fn()
        rec["chain"] = dict(bits_differing=0, launches=dict(depth_ops.launch_counts),
                            ms=device_ms(chain_fn, 10))
        depth_ops.reset_launch_counts()
        if on_path:  # what a chain puts on the stream
            rec["chain"]["stream_ops"] = stream_ops(chain_fn)
            if old is not None:
                old_chain = (lambda: old.depth_to_normals(d, intr, 40))
                rec["chain"]["baseline_stream_ops"] = stream_ops(old_chain)
                time_in_turns(chain_fn, old_chain, 10, rec["chain"])
        fill_recs.append(rec)
    # the generic instantiations, which no path runs: K9 at radius 3 (sigma_d 1.5),
    # K10 at radius 3 (4 slots a lane) and at radius 6 (169 taps, 35 slots a lane)
    for what, fn, plain in (
            ("depth_bilateral radius 3", lambda: depth_ops.bilateral_filter(depth, 1.5),
             lambda: depth_ops.bilateral_filter_plain(depth, 1.5)),
            ("depth_median_round radius 3", lambda: depth_ops.median_fill(depth, 3),
             lambda: depth_ops.median_fill_plain(depth, 3)),
            ("depth_median_round radius 6", lambda: depth_ops.median_fill(depth, 6),
             lambda: depth_ops.median_fill_plain(depth, 6))):
        diff = bits_differing([fn()], [plain()])
        if diff:
            raise SystemExit(f"chip_smoke: {what}: {diff} elements differ from its plain version")
    for k, recs in results.items():
        print(f"compare_raycast: {k} identical to its plain version on the card on "
              f"{[r['case'] for r in recs]}", flush=True)
    print("compare_raycast: K9 at radius 3 and K10 at radii 3 and 6 (the generic "
          "instantiations) identical to their plain versions on the step's frames", flush=True)
    return results, fill_recs


def phase_compare_raycast():
    bt = path_batch()
    xla_rec = compare_xla_arith(bt)
    print(f"compare_raycast: xla_arith card vs CPU bits differing {xla_rec}", flush=True)
    setup_depth, fill_recs = compare_setup_depth(bt)
    del bt
    gen = torch.Generator().manual_seed(5)
    results = {k: [] for k in RAYCAST_KERNELS}
    results.update(setup_depth)
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
    keys = ("grid", "dims", "case", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
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
                                   "grids",
                    **{k: "identical to the plain version on the card to the bit, on every "
                          "case" for k in SETUP_DEPTH_KERNELS}},
         summary={k: [{kk: r[kk] for kk in r if kk in keys or kk.endswith("_ms")} for r in v]
                  for k, v in results.items()},
         xla_arith=xla_rec, fill_depth_holes=fill_recs,
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
    if any(t in k for t in ("raycast_box", "raycast_rays", "raycast_bounds", "raycast_setup")):
        return "raycast_setup"  # K12's two kernels (and those of older versions)
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


def against_plain_twin(gen, plain, x, m, what, launches=28):
    """One eval forward of ``gen`` (the hand kernels: ``launches``, 28 at the
    default max_dilation) and of its twin whose convs are the kernels' plain
    versions (no launch) on (x, m): every output within 1e-3 of the twin's
    and finite. Returns (seconds of gen's forward, max abs difference by
    output, max abs output by output)."""
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
    if n_kernel != launches or sum(conv_ops.launch_counts.values()) != launches:
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


@contextlib.contextmanager
def recording_chunked_run(seen):
    """Inside, run_chunked_inference (which the chunked CLI keeps to itself)
    records into ``seen`` its outputs, its seconds (host clock, synchronised),
    the generator and the arguments it was given."""
    real_run = chunked.run_chunked_inference

    def run(generator, scene_input, scene_mask, *a, **kw):
        torch.cuda.synchronize()
        t = time.time()
        out = real_run(generator, scene_input, scene_mask, *a, **kw)
        torch.cuda.synchronize()
        seen.update(out=out, seconds=time.time() - t, generator=generator,
                    scene_input=scene_input, scene_mask=scene_mask, args=a, kwargs=kw)
        return out

    chunked.run_chunked_inference = run
    try:
        yield real_run
    finally:
        chunked.run_chunked_inference = real_run


def phase_path(tmp, par):
    cfg = TrainConfig()  # reference defaults: nf_gen 20, (128,64,64), colour + semantics
    gen = seeded_generator(cfg)
    ckpt = os.path.join(tmp, "model-seed0.pt")
    state.save_checkpoint(ckpt, gen, 0)
    del gen

    # the CLI keeps the stitched scene to itself: record what it passes on
    seen = {}
    out_dir = os.path.join(tmp, "output")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    t = time.time()
    with recording_chunked_run(seen):
        summary = cli.main(["--synthetic_scenes", "1", "--model_path", ckpt, "--output", out_dir,
                            "--num_to_vis", "1"])
    cli_seconds = time.time() - t
    launches = all_launch_counts()

    want = {"conv3x3_act_stats": 23 * 4, "conv3x3": 5 * 4, "conv3x3_dw": 0,
            "raycast_march": 0, "raycast_shade": 0, "raycast_scatter": 0, "raycast_occ": 0,
            "tsdf_integrate": 0, "libconv_dw": 0, **NO_SETUP_DEPTH}
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


@contextlib.contextmanager
def recording_scene_cli(seen, renders):
    """Inside, the whole-scene CLI's run_whole_scene records into ``seen``
    its outputs, seconds and peak memory (timed_scene), the peak before it,
    the generator and its arguments; each render_views call appends its
    arguments, seconds and hit pixels to ``renders``. Yields the real
    run_whole_scene."""
    from spsg_tpu_torch.cli import test_scene as scene_cli
    from spsg_tpu_torch.inference import whole_scene

    real_run, real_render = whole_scene.run_whole_scene, scene_cli.render_views

    def run(generator, scene_input, scene_mask, **kw):
        seen["peak_before"] = torch.cuda.max_memory_allocated()
        out, seconds, peak = timed_scene(real_run, generator, scene_input, scene_mask, kw)
        seen.update(out=out, seconds=seconds, forward_peak=peak, generator=generator,
                    scene_input=scene_input, scene_mask=scene_mask, kwargs=kw)
        return out

    def render(*args, **kw):
        torch.cuda.synchronize()
        t = time.time()
        images = real_render(*args, **kw)  # numpy images: the card is done
        renders.append(dict(args=args, seconds=time.time() - t,
                            hits=int(np.isfinite(images["depth"]).sum())))
        return images

    whole_scene.run_whole_scene, scene_cli.render_views = run, render
    try:
        yield real_run
    finally:
        whole_scene.run_whole_scene, scene_cli.render_views = real_run, real_render


def bf16_scene(cfg, seen, want, run):
    """The scene of ``seen`` (recording_scene_cli) again with the generator in
    bf16 (the kernels' bf16 variants, bf16 library convs, f32 heads): the
    launches of ``want`` without the renders' and finite outputs held; its
    seconds, peak memory and difference from the float32 scene."""
    g16 = state.make_generator(dataclasses.replace(cfg, compute_dtype="bfloat16"), DEV)
    g16.load_state_dict(seen["generator"].state_dict())
    reset_all_launch_counts()
    out16, seconds, peak16 = timed_scene(run, g16, seen["scene_input"], seen["scene_mask"],
                                         seen["kwargs"])
    launches16 = all_launch_counts()
    if launches16 != dict(want, raycast_march=0, raycast_shade=0, raycast_setup=0) or not all(
            np.isfinite(o).all() for o in out16):
        raise SystemExit(f"chip_smoke: the bf16 scene launched {launches16}, or is not finite")
    rec = dict(
        seconds_per_scene=seconds, voxels_per_second=float(np.prod(out16[0].shape)) / seconds,
        max_memory_allocated=peak16, launches=launches16,
        max_abs_diff_from_float32={n: float(np.abs(a - b).max())
                                   for n, a, b in zip(OUTPUTS, out16, seen["out"])},
        rms_diff_from_float32={n: float(np.sqrt(np.mean((a - b) ** 2.0)))
                               for n, a, b in zip(OUTPUTS, out16, seen["out"])})
    return rec, g16


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
    out_dir = os.path.join(tmp, "scene")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    t = time.time()
    with recording_scene_cli(seen, renders) as real_run:
        scene_cli.main(["--synthetic_scenes", "1", "--model_path", pth, "--output", out_dir])
    cli_seconds = time.time() - t
    launches = all_launch_counts()
    peak = max(seen["peak_before"], torch.cuda.max_memory_allocated())

    want = {"conv3x3_act_stats": 23, "conv3x3": 5, "conv3x3_dw": 0, "raycast_march": 3,
            "raycast_shade": 3, "raycast_scatter": 0, "raycast_occ": 0, "tsdf_integrate": 0,
            "libconv_dw": 0, **NO_SETUP_DEPTH, "raycast_setup": 3}
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

    # one scene in bf16
    rec["bfloat16"], g16 = bf16_scene(cfg, seen, want, real_run)
    x, m = torch.from_numpy(inp[None]).to(DEV), torch.from_numpy(msk[None]).to(DEV)
    rec["bfloat16"]["forward_device_time"] = profile_forward(g16.eval(), x, m)
    del g16, x, m

    # K4 / K5 on the prediction's render, against their plain versions
    cfg_rc = renders[2]["args"][6]
    march_rec, shade_rec = scene_render_kernels(renders[2]["args"], cfg_rc)
    if rc_results is not None:  # None when --phases left compare_raycast out
        rc_results["raycast_march"].append(march_rec)
        rc_results["raycast_shade"].append(shade_rec)
    rec["prediction_render"] = {k: {kk: r[kk] for kk in ("hits", "ms", "plain_ms", "library_ms",
                                                         "bound_ms", "bound_by")}
                                for k, r in (("raycast_march", march_rec),
                                             ("raycast_shade", shade_rec))}
    rec["prediction_render"]["raycast_march"].update(
        {k: march_rec[k] for k in ("samples_per_ray", "in_blocks_per_ray", "evaluated_per_ray")})
    print(f"scene: {SCENE_DIMS} {seen['seconds']:.4f} s a scene "
          f"({vox / seen['seconds']:.4g} voxels/s), peak {peak} bytes; {BIG_SCENE} "
          f"{rec['reference_bound']['seconds_per_scene']:.4f} s, peak {big_peak} bytes; bf16 "
          f"{rec['bfloat16']['seconds_per_scene']:.4f} s, peak "
          f"{rec['bfloat16']['max_memory_allocated']} bytes", flush=True)
    emit("scene", **rec)
    return launches, rec


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


def grads_of(x, module="generator"):
    """{name: gradient, float32 on the CPU} of ``module`` of a trainer after a
    step; a dict of that form is returned as it is."""
    if isinstance(x, dict):
        return x
    return {n: p.grad.float().cpu() for n, p in getattr(x, module).named_parameters()}


def leaf_gaps(a, b, what, module="generator"):
    """Parameter gradients of ``module`` of two trainers (or :func:`grads_of`
    dicts) after the same step: ({name: max |a - b| over the largest |b|}
    over the leaves that have a gradient, [the leaves whose gradient is
    rounding noise on both sides])."""
    noise, errs = [], {}
    ga, gb = grads_of(a, module), grads_of(b, module)
    largest = max(r.abs().max().item() for r in gb.values())
    for name, g in ga.items():
        r = gb[name]
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


# The gradient rule of the card (ROADMAP.md Queue C, agreed tolerances): see
# grad_rule. Its constants, from the gradient witness's readings (NVIDIA H100 80GB HBM3,
# the full step at TrainConfig() width on seeds 0 / 1 / 2, each generator leaf's
# max difference from the step with float64 library convs over the leaf's
# largest entry): worst leaf of the default step 9.739e-3 / 1.420e-3 / 1.136e-2,
# of the z-slab step 3.643e-3 / 1.716e-2 / 5.066e-3, of the folded step 9.803e-3 /
# 1.731e-2 / 1.153e-2; median leaf 5.2e-4 / 3.1e-4 / 8.7e-4 (default), 4.7e-4 /
# 3.9e-4 / 6.5e-4 (z-slab), 8.0e-4 / 3.5e-4 / 1.0e-3 (folded): a form's median at
# most 1.54 times the default's on the same seed.
GRAD_RULE_K = 3.0          # a leaf at most 3 times the reference's distance ...
GRAD_RULE_FLOOR = 1e-2     # ... or 3 times what one slope flip moves a leaf by
GRAD_RULE_MEDIAN_K = 3.0   # the median leaf at most 3 times the reference's
RULE_SECONDS = [0.0]       # the yardstick steps' seconds, the rule's cost


def grad_rule(cand, ref, yard, what, hold=True):
    """The gradient rule: the generator's gradients of a candidate step
    (``cand``: hand kernels, a conv form, two ranks, a fault) against those
    of a reference float32 step of the same state on the same batch (``ref``:
    the plain-conv twin, or the default step), both measured from a yardstick
    (``yard``: the reference's step with its seven library convs in float64).
    Each is a trainer after its step or a :func:`grads_of` dict; d(x, y) of
    a leaf is max |x - y| over y's largest entry.

    Held: for every leaf d(cand, yard) <= GRAD_RULE_K * max(d(ref, yard),
    GRAD_RULE_FLOOR), and the median leaf's d(cand, yard) <= GRAD_RULE_MEDIAN_K
    times the reference's median. Why not d(cand, ref) <= 1e-2, the earlier
    rule: a float32 step flips the LeakyReLU slope of ~300 of its 3.1e8
    activations against the yardstick, and one flip moves some leaf by ~1e-2,
    a lottery over seeds that the reference loses as often as the candidate
    (the readings above GRAD_RULE_K): the reference's own distance, floored
    at one flip's move, is what a float32 step may read; a fault that moves
    every leaf moves the median, which the flips leave at 3e-4 - 1e-3.

    Returns the readings (the rule's and d(cand, ref), what the 1e-2 rule
    read); with ``hold`` raises SystemExit if the rule fails."""
    dc, noise = leaf_gaps(cand, yard, what)
    dr, _ = leaf_gaps(ref, yard, what)
    share = {n: dc[n] / (GRAD_RULE_K * max(dr[n], GRAD_RULE_FLOOR)) for n in dc}
    worst = max(share, key=share.get)
    med_c, med_r = float(np.median(list(dc.values()))), float(np.median(list(dr.values())))
    old = leaf_gaps(cand, ref, what)[0]
    old_worst = max(old, key=old.get)
    rec = dict(
        passed=bool(share[worst] <= 1.0 and med_c <= GRAD_RULE_MEDIAN_K * med_r),
        worst_leaf=worst, worst_leaf_share_of_limit=share[worst],
        worst_leaf_vs_yardstick=dc[worst], reference_vs_yardstick_on_worst_leaf=dr[worst],
        largest_vs_yardstick=max(dc.values()), reference_largest_vs_yardstick=max(dr.values()),
        median_vs_yardstick=med_c, reference_median_vs_yardstick=med_r,
        median_share_of_limit=med_c / (GRAD_RULE_MEDIAN_K * med_r),
        vs_reference_max_rel_diff=old[old_worst], vs_reference_worst_parameter=old_worst,
        parameters_with_gradient=len(dc), gradients_of_rounding_noise=noise)
    if hold and not rec["passed"]:
        raise SystemExit(f"chip_smoke: {what}: the gradient rule fails: {rec}")
    return rec


def float64_library_convs(trainer):
    """The trainer's generator with its library convs in float64, forward and
    backward: the gradient rule's yardstick."""
    for b in trainer.generator.modules():
        if isinstance(b, ConvBlock) and not b.eligible:
            b._library_conv = _library_conv_float64.__get__(b)
    return trainer


def clone_trainer(src, cfg=None, plain=False, float64=False):
    """A trainer on ``src``'s device (plain convs with ``plain``, float64
    library convs with ``float64``; ``cfg`` or ``src``'s configuration) holding
    ``src``'s generator, discriminator and spectral state, with fresh Adams."""
    tr = Trainer(cfg or src.cfg, src.device, seed=0, plain_convs=plain)
    tr.generator.load_state_dict(src.generator.state_dict())
    if src.discriminator is not None and tr.discriminator is not None:
        tr.discriminator.load_state_dict(src.discriminator.state_dict())
        tr.sn_state = {k: {kk: vv.clone() for kk, vv in v.items()}
                       for k, v in src.sn_state.items()}
    return float64_library_convs(tr) if float64 else tr


def yardstick_step(tr, batch, flags, plain_raycast):
    """One step of a yardstick trainer (:func:`clone_trainer` with
    ``float64``); its generator's gradients (:func:`grads_of`). Its seconds
    count into RULE_SECONDS."""
    t = time.time()
    with plain_raycast_inside() if plain_raycast else contextlib.nullcontext():
        tr.step(batch, flags)
    grads = grads_of(tr)
    RULE_SECONDS[0] += time.time() - t
    return grads


def compare_trainers(a, b, ma, mb, metric_tol, what, yard=None):
    """Metrics and the generator's parameter gradients of two trainers after
    the same step: with a yardstick ``yard`` the gradients held to the rule
    (:func:`grad_rule`, ``b`` the reference), else reported."""
    if set(ma) != set(mb):
        raise SystemExit(f"chip_smoke: {what}: metrics {sorted(ma)} vs {sorted(mb)}")
    mdiff = {k: rel_diff(ma[k], mb[k]) for k in ma}
    bad = {k: v for k, v in mdiff.items() if not v <= metric_tol}
    if bad or not all(np.isfinite(float(v)) for v in ma.values()):
        raise SystemExit(f"chip_smoke: {what}: metrics differ: {bad}, {ma} vs {mb}")
    grads = (compare_grads(a, b, None, what) if yard is None
             else dict(gradient_rule=grad_rule(a, b, yard, what)))
    return dict(metrics_max_rel_diff=max(mdiff.values()), **grads)


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
    twin = clone_trainer(trainer, plain=True)
    yard = clone_trainer(trainer, plain=True, float64=True)
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
    yard = yardstick_step(yard, batch, full, False)
    # (b) launch counters of one step: 28 eligible convs forward, 25 backward (the
    # three convs of the colour head have no loss without the 2D terms); the seven
    # library convs' dW; no raycast
    want = {"conv3x3_act_stats": 23, "conv3x3": 5 + 25, "conv3x3_dw": 25,
            "raycast_march": 0, "raycast_shade": 0, "raycast_scatter": 0, "raycast_occ": 0,
            "tsdf_integrate": 0, "libconv_dw": 7, **NO_SETUP_DEPTH}
    if launches != want:
        raise SystemExit(f"chip_smoke: launches of one train step {launches}, expected {want}")
    rec = dict(config=dict(nf_gen=cfg.nf_gen, input_dim=list(cfg.input_dim),
                           batch_size=cfg.batch_size, lr=cfg.lr, flags=FULL_3D),
               launches_per_step=dict(launches), max_memory_allocated=peak,
               twin_max_memory_allocated=twin_peak,
               first_step_metrics={k: float(v) for k, v in metrics.items()},
               kernels_vs_plain_twin=compare_trainers(trainer, twin, metrics, twin_metrics,
                                                      1e-4, "train step vs plain-conv twin",
                                                      yard))
    if not (metrics["loss_occ"] > 0 and metrics["loss_sdf"] > 0 and metrics["loss_semantic"] > 0
            and 0 < metrics["iou_occ"] < 1):
        raise SystemExit(f"chip_smoke: the first step's losses are degenerate: {metrics}")
    del twin, yard
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
    # (the geometry net's three library convs: geo_0a, geo_0b, geo_1a)
    want = {"conv3x3_act_stats": 9, "conv3x3": 2 + 11, "conv3x3_dw": 11,
            "raycast_march": 0, "raycast_shade": 0, "raycast_scatter": 0, "raycast_occ": 0,
            "tsdf_integrate": 0, "libconv_dw": 3, **NO_SETUP_DEPTH}
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
        pair["cuda"][0], pair["cpu"][0], pair["cuda"][1], pair["cpu"][1], 1e-4,
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
           "tsdf_integrate": 0, "raycast_setup": 3, "depth_bilateral": 1,
           # one cooperative launch of K10 runs every round of the fill
           "depth_median_round": 1, "depth_normals": 1,
           # the dW of the seven library convs, in float32
           "libconv_dw": 7}
# the 2D and adversarial metrics of two float32 forwards part where a
# prediction pixel's hit flips (one pixel moves a mean over a few thousand by
# ~1e-4): those are held to 1e-3, the 3D metrics to 1e-4
METRICS_3D = ("loss_occ", "iou_occ", "loss_sdf", "loss_semantic")


# the full step's batch and unstepped trainer, by seed (full_step_fixture), and
# the gradients of steps taken from them that several phases hold to the rule
_FULL_STEP, _STEP_GRADS = {}, {}


def full_step_fixture(seed=0):
    """The full step's fixture for ``seed``: the batch of make_chunk_batch's
    seed 7 + seed (TrainConfig() chunks, one 320x256 frame a chunk rendered
    on the card) and a trainer that is never stepped (Trainer(seed=seed),
    conv weights x2, the occupancy head centred on the batch); clone it with
    :func:`clone_trainer`. Cached: train2d, conv_forms and parallel share
    seed 0's, the gradient witness and parallel seeds 0-2. Returns (batch,
    trainer, seconds that rendering the frames took)."""
    if seed not in _FULL_STEP:
        from spsg_tpu_torch.data import synthetic

        cfg = TrainConfig()
        t = time.time()
        batch = synthetic.make_chunk_batch(cfg.batch_size, cfg.input_dim,
                                           (cfg.style_width, cfg.style_height), seed=7 + seed,
                                           with_frames=True, device=DEV)
        frames_seconds = time.time() - t
        batch.pop("name")
        batch["weight_occ"] = np.float32(cfg.weight_occ_loss)
        base = Trainer(cfg, DEV, seed=seed)
        scale_conv_weights(base.generator, 2.0)
        centre_train_occupancy(base, batch)
        _FULL_STEP[seed] = (batch, base, frames_seconds)
    return _FULL_STEP[seed]


def full_step_grads(kind, seed=0):
    """The generator's gradients (:func:`grads_of`) of one full step from
    :func:`full_step_fixture` (``seed``), cached: ``kind`` "default" (the
    kernels, float32: the rule's reference for the conv forms and two ranks),
    "yard_default" (the same with float64 library convs: their yardstick) or
    "yard_plain" (plain convs and plain raycaster, float64 library convs: the
    yardstick of the kernels against the plain twin)."""
    if (kind, seed) not in _STEP_GRADS:
        batch, base, _ = full_step_fixture(seed)
        flags = StepFlags(**FULL_2D)
        if kind == "default":
            tr = clone_trainer(base)
            tr.step(batch, flags)
            grads = grads_of(tr)
        else:
            plain = kind == "yard_plain"
            grads = yardstick_step(clone_trainer(base, plain=plain, float64=True), batch, flags,
                                   plain)
        _STEP_GRADS[kind, seed] = grads
        torch.cuda.empty_cache()
    return _STEP_GRADS[kind, seed]


# (module, name of the dispatching function, its plain version) of the raycaster,
# its set-up and the depth chain
PLAIN_RAYCAST = [(rc_ops, n, getattr(rc_ops, f"{n}_plain"))
                 for n in ("march", "shade", "scatter", "occ_march", "march_setup")] + [
    (depth_ops, n, getattr(depth_ops, f"{n}_plain"))
    for n in ("fill_depth_holes", "unproject_normals", "depth_to_normals")]


@contextlib.contextmanager
def plain_raycast_inside():
    """Inside, the raycaster, its ray set-up and the depth chain take their
    plain versions on CUDA tensors too."""
    saved = [getattr(mod, name) for mod, name, _ in PLAIN_RAYCAST]
    for mod, name, plain in PLAIN_RAYCAST:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(PLAIN_RAYCAST, saved):
            setattr(mod, name, fn)


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
    twin = clone_trainer(trainer, plain=True)
    yard = clone_trainer(trainer, plain=True, float64=True)
    seen = {}
    reset_all_launch_counts()
    with recording_views(seen):
        metrics = trainer.step(batch, flags)
        torch.cuda.synchronize()
    launches = all_launch_counts()
    want = dict(WANT_2D, raycast_occ=2, raycast_setup=5)
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
    yard = yardstick_step(yard, batch, flags, True)
    rec = dict(launches_per_step=launches, weighted_pixels=weighted,
               metrics={k: float(v) for k, v in metrics.items()},
               kernels_vs_plain_twin=dict(
                   metrics_rel_diff=compare_metrics(metrics, twin_metrics,
                                                    "missing-colour step vs plain twin"),
                   gradient_rule=grad_rule(trainer, twin, yard,
                                           "missing-colour step vs plain twin")))
    del twin, yard
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
    batch, base, frames_seconds = full_step_fixture(0)
    flags = StepFlags(**FULL_2D)
    rec = dict(config=dict(nf_gen=cfg.nf_gen, input_dim=list(cfg.input_dim),
                           batch_size=cfg.batch_size, image=[cfg.style_width, cfg.style_height],
                           nf_disc=cfg.nf_disc, patch_size=cfg.patch_size,
                           disc_loss_type=cfg.disc_loss_type, flags=FULL_2D),
               frames_seconds=frames_seconds,
               frame_holes=int((batch["images_depth"] == 0).sum()))

    trainer = clone_trainer(base)
    twin = clone_trainer(base, plain=True)
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
            # versions, by the gradient rule (the plain twin's yardstick)
            gradient_rule=grad_rule(trainer, twin, full_step_grads("yard_plain", 0),
                                    "full step vs plain twin"),
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
    # the library convs in bf16 keep the library's weight gradient
    want = dict(WANT_2D, libconv_dw=0)
    if launches != want or seen != want_types:
        raise SystemExit(f"chip_smoke: launches of one bf16 step {launches} (by storage type "
                         f"{seen}), expected {want} ({want_types})")
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
# the library convs whose dW is the hand kernel's with each form: zslab_conv takes
# all seven, folded_conv the two 5^3 entry convs
WANT_2D_FORMS = {"zslab_conv": dict(WANT_2D, libconv_dw=0),
                 "folded_conv": dict(WANT_2D, libconv_dw=5), "remat": WANT_2D_REMAT}
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


def conv_forms_steps():
    """The full default step (train2d's configuration, weights and batch) and
    the same step with each form and with remat, each trainer from the same
    state: launches of the first step, its metrics and the generator's
    gradients against the default step's; then one warm-up and three timed
    steps (median seconds, peak memory) and device time by kind."""
    batch, base, _ = full_step_fixture(0)
    flags = StepFlags(**FULL_2D)
    trainers, recs, launches, first = {}, {}, {}, {}
    for name in ("default",) + FORM_FLAGS + ("remat",):
        kw = {} if name == "default" else {name: True}
        tr = clone_trainer(base, dataclasses.replace(base.cfg, **kw))
        reset_all_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics = tr.step(batch, flags)
        torch.cuda.synchronize()
        launches[name] = all_launch_counts()
        want = WANT_2D_FORMS.get(name, WANT_2D)
        if launches[name] != want:
            raise SystemExit(f"chip_smoke: conv_forms: launches of the full step with {name} "
                             f"{launches[name]}, expected {want}")
        trainers[name], first[name] = tr, metrics
        recs[name] = dict(launches_per_step=launches[name],
                          first_step_max_memory_allocated=torch.cuda.max_memory_allocated(),
                          first_step_metrics={k: float(v) for k, v in metrics.items()})
        if name != "default":
            # metrics at train2d's rule; the generator's gradients by the gradient
            # rule, the default step the reference (the witness below: on 3 seeds)
            recs[name]["against_default"] = dict(
                metrics_rel_diff=compare_metrics(metrics, first["default"],
                                                 f"full step with {name} vs default"),
                gradient_rule=grad_rule(tr, trainers["default"],
                                        full_step_grads("yard_default", 0),
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


# the steps of the gradient rule's cases: the kernels' and the forms' float32
# steps, the plain-conv twin, the two yardsticks (float64 library convs) and two
# seeded faults; each case: (candidate, reference, yardstick, whether it passes)
WITNESS_STEPS = ("float64", "default", "default_again", "zslab_conv", "folded_conv", "plain",
                 "float64_plain", "fault_zslab_tap", "fault_k2_tap")
RULE_CASES = {
    "default": ("default", "plain", "float64_plain", True),
    "zslab_conv": ("zslab_conv", "default", "float64", True),
    "folded_conv": ("folded_conv", "default", "float64", True),
    "fault_zslab_tap": ("fault_zslab_tap", "default", "float64", False),
    "fault_k2_tap": ("fault_k2_tap", "plain", "float64_plain", False),
}
FAULT_LAYER = "encoder_1a"  # the z-slab fault's conv (4^3, stride 2)


def zslab_wrong_tap(self, x, dt, halo):
    """ConvBlock._library_conv on the z-slab route with the weight tap at the
    kernel's centre read from its neighbour along x (a wrong index into the
    weight of one library conv): a seeded fault of the gradient rule."""
    c = self.weight.shape[2] // 2
    w = self.weight.to(dt).clone()
    w[:, :, c, c, c] = self.weight[:, :, c, c, c + 1].to(dt)
    p = self.padding
    return conv3d_zslab(x, w.permute(2, 3, 4, 1, 0), self.stride, (p, 0, p) if halo else p,
                        self.dilation)


@contextlib.contextmanager
def k2_wrong_tap():
    """Inside, the first weight gradient that K2's wrapper gives has its
    centre tap's entries replaced by its neighbour's along x (one wrong tap in
    K2's output): a seeded fault of the gradient rule."""
    real, calls = conv_ops.conv3x3_dw, []

    def faulty(x, dy):
        dw = real(x, dy)
        calls.append(tuple(dw.shape))
        if len(calls) == 1:
            dw = dw.clone()
            dw[1, 1, 1] = dw[1, 1, 2]
        return dw

    conv_ops.conv3x3_dw = faulty
    try:
        yield calls
    finally:
        conv_ops.conv3x3_dw = real


def witness_steps(base, batch, flags, names=WITNESS_STEPS):
    """One step of each of ``names`` from ``base``'s state on ``batch``
    (:func:`clone_trainer`): "float64" / "float64_plain" with float64 library
    convs (plain convs and the plain raycaster for the latter, and for
    "plain"), the forms with their flag, "fault_zslab_tap" the z-slab step with
    :func:`zslab_wrong_tap` in FAULT_LAYER, "fault_k2_tap" the default step
    under :func:`k2_wrong_tap`. Returns ({name: grads_of}, {name: metrics},
    {name: the LeakyReLU slopes of its forward, SlopeSigns})."""
    grads, metrics, signs = {}, {}, {}
    for name in names:
        kw = ({"zslab_conv": True} if name in ("zslab_conv", "fault_zslab_tap")
              else {"folded_conv": True} if name == "folded_conv" else {})
        plain = name in ("plain", "float64_plain")
        tr = clone_trainer(base, dataclasses.replace(base.cfg, **kw), plain=plain,
                           float64=name.startswith("float64"))
        if name == "fault_zslab_tap":
            block = getattr(tr.generator, FAULT_LAYER)
            block._library_conv = zslab_wrong_tap.__get__(block)
        hooks = SlopeSigns(tr.generator)
        t = time.time()
        with (plain_raycast_inside() if plain else k2_wrong_tap() if name == "fault_k2_tap"
              else contextlib.nullcontext()):
            m = tr.step(batch, flags)
        grads[name] = grads_of(tr)
        if name.startswith("float64"):
            RULE_SECONDS[0] += time.time() - t
        signs[name] = hooks.remove()
        metrics[name] = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in metrics[name].values()):
            raise SystemExit(f"chip_smoke: gradient witness: the step {name} is not finite: "
                             f"{metrics[name]}")
        del tr, hooks
    return grads, metrics, signs


def rule_cases(grads, what):
    """The gradient rule on each of RULE_CASES (readings, not held), with
    whether the 1e-2 rule (d(candidate, reference) <= 1e-2) would pass and
    whether each verdict is the expected one."""
    out = {}
    for case, (cand, ref, yard, should_pass) in RULE_CASES.items():
        r = grad_rule(grads[cand], grads[ref], grads[yard], f"{what} {case}", hold=False)
        r.update(expected_to_pass=should_pass, as_expected=r["passed"] == should_pass,
                 old_rule_passed=bool(r["vs_reference_max_rel_diff"] <= 1e-2))
        out[case] = r
    return out


def conv_forms_gradient_witness(seeds=WITNESS_SEEDS):
    """The gradient rule on three seeds (full_step_fixture's weights and
    batches), each step of WITNESS_STEPS from one state: RULE_CASES held (the
    kernels against the plain twin, each form against the default step: pass;
    the two seeded faults: fail, on every seed, and on each seed one fault
    that the 1e-2 rule fails too), with both faults' readings; and, reported as
    before the rule, per leaf each float32 step's generator gradients against the
    float64 step's (and the forms' against the default's) over the leaf's
    largest entry, the readings of every step on the leaf that is worst
    between zslab_conv and the default, and the LeakyReLU slope flips of each
    step's forward against the float64 step's. The float64, default and
    plain yardstick gradients join full_step_grads' cache (the parallel phase
    holds two ranks to the rule on the same seeds)."""
    flags = StepFlags(**FULL_2D)
    out, broken = [], []
    for seed in seeds:
        batch, base, _ = full_step_fixture(seed)
        grads, metrics, signs = witness_steps(base, batch, flags)
        for kind, name in (("default", "default"), ("yard_default", "float64"),
                           ("yard_plain", "float64_plain")):
            _STEP_GRADS.setdefault((kind, seed), grads[name])
        names = ("float64", "default", "default_again") + FORM_FLAGS
        pairs = {f"{n}_vs_float64": (n, "float64") for n in names[1:]}
        pairs.update({f"{n}_vs_default": (n, "default") for n in ("default_again",) + FORM_FLAGS})
        gaps = {k: leaf_gaps(grads[a], grads[b], f"witness seed {seed} {k}")[0]
                for k, (a, b) in pairs.items()}
        leaf = max(gaps["zslab_conv_vs_default"], key=gaps["zslab_conv_vs_default"].get)
        rec = dict(seed=seed, batch_seed=7 + seed, zslab_worst_leaf=leaf,
                   on_zslab_worst_leaf={k: g[leaf] for k, g in gaps.items()},
                   rule=rule_cases(grads, f"witness seed {seed}"))
        for k, g in gaps.items():
            worst = sorted(g, key=g.get)[-3:][::-1]
            rec[k] = dict(worst=[[n, g[n]] for n in worst],
                          median=float(np.median(list(g.values()))),
                          metrics_max_rel_diff=max(rel_diff(metrics[pairs[k][0]][q],
                                                            metrics[pairs[k][1]][q])
                                                   for q in metrics["float64"]))
        rec["slope_flips_vs_float64"] = {n: slope_flips(signs[n], signs["float64"])
                                         for n in WITNESS_STEPS[1:]}
        rec["slope_flips_default_again_vs_default"] = slope_flips(signs["default_again"],
                                                                  signs["default"])
        broken += [(seed, c) for c, r in rec["rule"].items() if not r["as_expected"]]
        if not any(not r["passed"] and not r["old_rule_passed"]
                   for c, r in rec["rule"].items() if not r["expected_to_pass"]):
            broken.append((seed, "no fault that the 1e-2 rule fails too"))
        out.append(rec)
        print(f"gradient rule seed {seed}: " + "; ".join(
            f"{c} {'passes' if r['passed'] else 'fails'} (leaf {r['worst_leaf']} "
            f"{r['worst_leaf_vs_yardstick']:.3e} of limit "
            f"{r['worst_leaf_vs_yardstick'] / r['worst_leaf_share_of_limit']:.3e}, median "
            f"{r['median_vs_yardstick']:.3e} of limit "
            f"{r['median_vs_yardstick'] / r['median_share_of_limit']:.3e}; the 1e-2 rule reads "
            f"{r['vs_reference_max_rel_diff']:.3e})" for c, r in rec["rule"].items())
              + "; slope flips against float64 " + ", ".join(
                  f"{n} {v['flipped']}" for n, v in rec["slope_flips_vs_float64"].items())
              + f" of {rec['slope_flips_vs_float64']['default']['of']}", flush=True)
        del grads, signs
        torch.cuda.empty_cache()
    if broken:
        raise SystemExit(f"chip_smoke: the gradient rule's witness: not as expected: {broken}")
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
    rec["steps"], step_launches, trainers = conv_forms_steps()
    rec["generator_remat_bits"] = generator_remat_bits(trainers, full_step_fixture(0)[0])
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
        + (f", gradient rule: leaf {g['worst_leaf']} {g['worst_leaf_share_of_limit']:.3f} of "
           f"its limit, median {g['median_share_of_limit']:.3f} of its limit"
           if (g := r.get("against_default", {}).get("gradient_rule")) else "")
        for n, r in rec["steps"].items()) + f"; phase {rec['seconds']:.1f} s", flush=True)
    emit("conv_forms", **rec)
    paths = {f"train2d_{n}": step_launches[n] for n in FORM_FLAGS + ("remat",)}
    paths.update({f"scene_{n}": scene_launches[n] for n in FORM_FLAGS})
    return paths


# --------------------------------------------------------------------------- trained
REPO = os.path.dirname(os.path.abspath(__file__))
# the JAX package's trained nf 20 model and its golden files (tools/export_torch_goldens.py)
TRAINED_DIR = os.path.join(REPO, "docs", "evidence", "torch_port", "epoch59")
# the JAX package's style run, continued from that model (its flags, bar the cuts below)
STYLE_RUN_ARGS = os.path.join(REPO, "docs", "evidence", "bench_r5", "style_run", "args.txt")
# the style run cut to 2 of its 40 epochs; its 64 synthetic chunks stay (16 would
# leave 2 validation chunks, fewer than a batch of 8: no validation at all)
STYLE_EPOCHS = 2
# the flags of args.txt that say where a run writes or which card it takes
STYLE_SKIP = ("save", "retrain", "retrain_disc", "gpu", "device", "distributed", "profile_dir",
              "synthetic_chunks", "max_epoch")
MEMORY_BATCHES = (2, 4, 8)
MEMORY_BUDGET = 0.9  # the share of the card's memory the largest batch is predicted to fill
# launches of one full step with GeneratorConfig.max_dilation 2: geo_1d (fused
# conv + LeakyReLU + BatchNorm) leaves K3 for the library route, and its dx / dW K1 / K2
WANT_2D_DILATION2 = dict(WANT_2D, conv3x3_act_stats=22, conv3x3=5 + 27, conv3x3_dw=27)


def load_goldens(directory=TRAINED_DIR):
    """(manifest, golden_val, golden_chunked, the .pt's path) of a directory
    that tools/export_torch_goldens.py wrote; every file's sha256 against the
    manifest's."""
    try:
        manifest = goldens.check_manifest(directory)
    except ValueError as e:
        raise SystemExit(f"chip_smoke: trained: {e}")
    with open(os.path.join(directory, "golden_val.json")) as f:
        val = json.load(f)
    with np.load(os.path.join(directory, "golden_chunked.npz")) as z:
        chunked_golden = {k: z[k] for k in z.files}
    pt = next(os.path.join(directory, n) for n in manifest["files"] if n.endswith(".pt"))
    return manifest, val, chunked_golden, pt


def run_config(raw, **changes):
    """The port's TrainConfig of the run whose args.txt is ``raw`` (the train
    CLI's flags, which are the JAX package's), float32 unless ``changes``
    say otherwise."""
    from spsg_tpu_torch.cli import train as train_cli

    ns = goldens.replay_args(train_cli.build_parser(), raw)
    return dataclasses.replace(train_cli.config_from_args(ns), compute_dtype=None, **changes)


def compare_chunked_golden(out, g, what):
    """A chunked scene (run_chunked_inference's outputs) against the JAX
    package's golden (golden_chunked.npz), at the rule of
    tests/test_torch_chunked.py::test_whole_slice_matches_jax_with_trained_weights:
    overlap counts, occupancy and labels equal on >= 99.9 % of the voxels; where
    the counts agree and a voxel has a prediction, the SDF within 1e-3 and the
    colour within 1; IoU and mIoU within 0.005; the class weights equal."""
    counts = g["counts"].astype(np.int64)
    if out.counts.shape != counts.shape:
        raise SystemExit(f"chip_smoke: {what}: scene {out.counts.shape}, golden {counts.shape}")
    occ = np.unpackbits(g["occ"])[:counts.size].reshape(counts.shape).astype(bool)
    idx = np.union1d(np.flatnonzero(counts > 0), g["sample_voxels"])  # sdf / colors' voxels
    got_counts = out.counts.reshape(-1)[idx]
    both = (got_counts == counts.reshape(-1)[idx]) & (got_counts > 0)
    summary = chunked.summarize_iou(out.geo_intersection, out.geo_union, out.class_intersection,
                                    out.class_union, out.class_weight)
    rec = dict(
        voxels=int(counts.size), predicted_voxels=int((out.counts > 0).sum()),
        golden_predicted_voxels=int((counts > 0).sum()),
        counts_agree=float((out.counts == counts).mean()),
        occupancy_agree=float((out.occ.astype(bool) == occ).mean()),
        labels_agree=float((out.sem_labels == g["sem_labels"]).mean()),
        sdf_voxels_compared=int(both.sum()),
        sdf_max_abs_diff=float(np.abs(out.sdf.reshape(-1)[idx][both] - g["sdf"][both]).max()),
        colors_max_abs_diff=int(np.abs(out.colors.reshape(-1, 3)[idx][both].astype(int)
                                       - g["colors"][both].astype(int)).max()),
        geo_iou=summary["geo_iou"], golden_geo_iou=float(g["geo_iou"]),
        mean_iou=summary["mean_iou"], golden_mean_iou=float(g["mean_iou"]),
        class_weight_equal=bool(np.array_equal(out.class_weight, g["class_weight"])))
    ok = (rec["counts_agree"] >= 0.999 and rec["occupancy_agree"] >= 0.999
          and rec["labels_agree"] >= 0.999 and rec["sdf_voxels_compared"] > 0
          and rec["sdf_max_abs_diff"] <= 1e-3 and rec["colors_max_abs_diff"] <= 1
          and abs(rec["geo_iou"] - rec["golden_geo_iou"]) <= 0.005
          and abs(rec["mean_iou"] - rec["golden_mean_iou"]) <= 0.005
          and rec["class_weight_equal"])
    if not ok:
        raise SystemExit(f"chip_smoke: {what}: the chunked scene against the JAX golden: {rec}")
    return rec


@contextlib.contextmanager
def pr16_render_arithmetic():
    """The arithmetic in which the port rendered the frames of the nf-20
    golden_val.json (PR 16, on the CPU), before its ray set-up and march took
    XLA's forms: every a * b + c rounded twice, PyTorch's own float32 square
    root, the division by the step a division. Swapped into ops/raycast.py's
    helpers while frames are rendered, so that those frames are made again
    to the bit (the golden keeps their sha256, not the frames)."""
    saved = {n: getattr(rc_ops, n) for n in ("fma32", "sqrt32", "div_const")}
    rc_ops.fma32 = lambda a, b, c: a * b + c
    rc_ops.sqrt32 = torch.sqrt
    rc_ops.div_const = rc_ops._div
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(rc_ops, n, f)


def golden_validation_set(cfg, golden, chunks=None):
    """golden_val.json's validation set as the golden took it (the chunks of
    index ``chunks``, default all): the train CLI's SyntheticChunkDataset(n,
    cfg, True, seed=2), its frames rendered on the CPU (a step moves them to
    its trainer's device) in the arithmetic of the port that wrote the golden
    (:func:`pr16_render_arithmetic`) where that gives the golden's frame,
    else by the port as it is (goldens written since, as the tests' nf-4
    ones)."""
    from spsg_tpu_torch.data import synthetic

    def render(i):
        b = synthetic.make_chunk_batch(
            1, cfg.input_dim, (cfg.style_width, cfg.style_height),
            seed=golden["validation_set"]["seed"] * 100000 + i, with_frames=True,
            truncation=cfg.truncation, device="cpu")
        sample = {k: (v[0] if isinstance(v, np.ndarray) else v) for k, v in b.items()}
        sample["name"] = f"synthetic_{i}"
        return sample

    out = []
    for i in range(golden["validation_set"]["chunks"]) if chunks is None else chunks:
        with pr16_render_arithmetic():
            sample = render(i)
        if goldens.frame_digest(sample) != golden["chunks"][i]["frame_sha256"]:
            sample = render(i)
        out.append(sample)
    return out


def port_validation(trainer, golden, samples):
    """The port's validation pass on ``samples`` (golden_validation_set), one
    chunk a step as the golden took it, on the views that precompute_views
    gives on the trainer's device as they are. The port's march and depth
    chain compute what XLA computes for the JAX package (ROADMAP.md Queue C,
    agreed arithmetic), so its own views are the golden's: each chunk's
    march_patches (where the JAX package's views differed from the port's
    when the golden was written) are checked against the patch values, not
    written in, and the own views' marches are hashed. Returns per chunk the
    metrics, the patched indices checked and those not holding the JAX
    value, and whether its frame's and its marches' sha256 are the golden's."""
    from spsg_tpu_torch.training.loop import _prepare_batch

    cfg, it = trainer.cfg, golden["iteration"]
    flags = StepFlags(**golden["flags"])
    out = []
    by_name = {gc["name"]: gc for gc in golden["chunks"]}
    for sample in samples:
        gc = by_name[sample["name"]]
        batch = _prepare_batch({k: v[None] for k, v in sample.items()
                                if isinstance(v, np.ndarray)}, cfg, it)
        views = trainer.precompute_views(batch)
        host = {k: v.cpu().numpy() for k, v in views.items()}
        m = trainer.step(batch, flags, precomp=views)
        out.append(dict(name=sample["name"],
                        frame_is_golden=goldens.frame_digest(batch) == gc["frame_sha256"],
                        patch_indices_checked={k: len(v[0])
                                               for k, v in gc["march_patches"].items()},
                        patch_indices_not_held=goldens.patches_not_held(host,
                                                                        gc["march_patches"]),
                        marches_are_golden=all(goldens.array_digest(host[k]) == h
                                               for k, h in gc["march_sha256"].items()),
                        metrics={k: float(v) for k, v in m.items()}))
    return out


def compare_val_golden(chunks, golden, what):
    """The port's validation metrics (:func:`port_validation`) against
    golden_val.json's, per chunk and their mean, at train2d's metric rule: the
    3D metrics within 1e-4 relative, the 2D and adversarial ones within 1e-3.
    Each chunk's frame and its own marches must be the golden's, and its own
    views must hold the JAX value at every index of its march_patches."""
    def limit(k):
        return 1e-4 if k in METRICS_3D else 1e-3

    def rel(ma, mb, where):
        if set(ma) != set(mb):
            raise SystemExit(f"chip_smoke: {what}: {where}: metrics {sorted(ma)} vs {sorted(mb)}")
        d = {k: rel_diff(ma[k], mb[k]) for k in ma}
        bad = {k: v for k, v in d.items() if not v <= limit(k)}
        if bad or not all(np.isfinite(v) for v in ma.values()):
            raise SystemExit(f"chip_smoke: {what}: {where} against the JAX golden: off by {bad} "
                             f"(port {ma}, golden {mb})")
        return d

    if [c["name"] for c in chunks] != [c["name"] for c in golden["chunks"]]:
        raise SystemExit(f"chip_smoke: {what}: chunks {[c['name'] for c in chunks]}")
    not_golden = [c["name"] for c in chunks
                  if not (c["frame_is_golden"] and c["marches_are_golden"])]
    if not_golden:
        raise SystemExit(f"chip_smoke: {what}: the frames or the own marches of "
                         f"{not_golden} are not the golden's")
    not_held = {c["name"]: c["patch_indices_not_held"] for c in chunks
                if any(c["patch_indices_not_held"].values())}
    if not_held:
        raise SystemExit(f"chip_smoke: {what}: views that do not hold the JAX value at the "
                         f"golden's patch indices: {not_held}")
    per_chunk = {c["name"]: rel(c["metrics"], gc["metrics"], c["name"])
                 for c, gc in zip(chunks, golden["chunks"])}
    mean = {k: float(np.mean([c["metrics"][k] for c in chunks])) for k in golden["mean"]}
    return dict(per_chunk_rel_diff=per_chunk, mean_rel_diff=rel(mean, golden["mean"], "mean"),
                mean=mean, worst_rel_diff=max(v for d in per_chunk.values() for v in d.values()),
                patch_indices_checked=[c["patch_indices_checked"] for c in chunks])


def trained_trainer(cfg, pt, device=DEV):
    """A trainer of ``cfg`` holding the .pt's generator, discriminator and
    spectral state."""
    tr = Trainer(cfg, device, seed=0)
    state.load_checkpoint(pt, tr)
    return tr


def style_run_argv(raw, parser):
    """The train CLI's flags of the run whose args.txt is ``raw``: each flag
    whose value differs from the parser's default, bar STYLE_SKIP."""
    argv = []
    for a in parser._actions:
        if not a.option_strings or a.dest in STYLE_SKIP or a.dest not in raw:
            continue
        v, opt = raw[a.dest], a.option_strings[0]
        if v == a.default:
            continue
        if isinstance(a, argparse.BooleanOptionalAction):
            argv.append(opt if v else "--no-" + opt[2:])
        elif isinstance(a, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
            argv.append(opt)  # its value is the one the flag sets, the default's other
        else:
            argv += [opt, str(v)]
    return argv


def trained_style_run(raw, pt, golden, save, mode):
    """The JAX package's style run on the card: the train CLI in this process
    with the flags of its args.txt (batch 8, bf16, style / content 0.01,
    geometry-only 1, before-content 1, render cache 64), --retrain the .pt,
    --start_epoch 60, cut to STYLE_EPOCHS epochs; ``mode`` "bfloat16" as the run, "float32", or "remat" (float32
    with --remat). Seconds per iteration by kind (the loop's PhaseTimer),
    peak memory, launches; every loss finite; the first validation's metrics
    within the golden's range over its chunks."""
    from spsg_tpu_torch.cli import train as train_cli
    from spsg_tpu_torch.utils import logging as port_logging

    start = int(raw["start_epoch"])
    argv = style_run_argv(raw, train_cli.build_parser()) + [
        "--retrain", pt, "--save", save, "--synthetic_chunks", str(raw["synthetic_chunks"]),
        "--max_epoch", str(start + STYLE_EPOCHS)]
    if mode != "bfloat16":
        argv += ["--compute_dtype", ""] + (["--remat"] if mode == "remat" else [])
    steps, lookups = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with recording_loop(steps, lookups):
        result = train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.time() - t
    launches, peak = all_launch_counts(), torch.cuda.max_memory_allocated()
    names = port_logging._HEADER_NAMES
    header = port_logging.make_header(["train"])[:-1] + [f"val_{h}" for h in names] + ["time"]
    lines = open(os.path.join(save, "log_val.csv")).read().splitlines()
    rows = [dict(zip(header, map(float, line.split(",")))) for line in lines[1:]]
    train_steps = [st for st in steps if st["train"]]
    iterations, kinds = [], {}
    for h, st in zip(result.timer.history, train_steps):
        kind = "geometry_only" if not st["use_2d"] else "full"
        iterations.append(dict(kind=kind, seconds=sum(h.values()),
                               **{f"{k}_seconds": v for k, v in h.items()}))
        kinds.setdefault(kind, []).append(sum(h.values()))
    first_val = {k: rows[0][f"val_{n}"] for n, k in zip(names, port_logging.LOSS_KEYS)}
    outside = {k: v for k, v in first_val.items() if k in golden["mean"] and not (
        min(c["metrics"][k] for c in golden["chunks"]) <= v
        <= max(c["metrics"][k] for c in golden["chunks"]))}
    finite = all(np.isfinite(v) for r in rows for v in r.values()) and all(
        torch.isfinite(p).all() for p in result.trainer.generator.parameters())
    if header != lines[0].split(",") or len(rows) != STYLE_EPOCHS or not finite or outside:
        raise SystemExit(f"chip_smoke: trained style run ({mode}): {len(rows)} rows of "
                         f"log_val.csv, finite {finite}, first validation outside the golden's "
                         f"range: {outside}")
    if result.trainer.generator.dtype != (torch.bfloat16 if mode == "bfloat16" else torch.float32):
        raise SystemExit(f"chip_smoke: trained style run ({mode}): the generator computes in "
                         f"{result.trainer.generator.dtype}")
    return dict(mode=mode, argv=argv, seconds=seconds, iterations=iterations,
                seconds_per_iteration={k: dict(n=len(v), median=sorted(v)[len(v) // 2],
                                               min=min(v), max=max(v)) for k, v in kinds.items()},
                max_memory_allocated=peak, launches=launches,
                steps=len(train_steps), style_steps=sum(1 for st in train_steps if st["use_2d"]),
                first_validation=first_val,
                last_row_losses={k: v for k, v in rows[-1].items() if k.startswith("train_")},
                cache=dict(hits=result.render_cache.hits, misses=result.render_cache.misses)
                if result.render_cache is not None else None), launches


def tiled_batch(batch, n):
    """The first ``n`` chunks of ``batch``, its chunks repeated as often as
    ``n`` needs (a memory measurement: the shapes are what counts)."""
    reps = -(-n // batch["input"].shape[0])
    return {k: (np.concatenate([v] * reps)[:n] if isinstance(v, np.ndarray) and v.ndim > 0
                else v) for k, v in batch.items()}


def memory_step(cfg, pt, batch, n):
    """One full step of a trainer with the .pt's weights on ``n`` chunks:
    (seconds, peak bytes, launches)."""
    tr = trained_trainer(cfg, pt)
    b = tiled_batch(batch, n)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    t = time.time()
    m = tr.step(b, StepFlags(**FULL_2D))
    torch.cuda.synchronize()
    rec = dict(batch=n, seconds=time.time() - t, max_memory_allocated=torch.cuda.max_memory_allocated(),
               max_memory_reserved=torch.cuda.max_memory_reserved(), loss=float(m["loss"]))
    launches = all_launch_counts()
    del tr, b, m
    torch.cuda.empty_cache()
    if not np.isfinite(rec["loss"]):
        raise SystemExit(f"chip_smoke: trained: the step on {n} chunks is not finite")
    return rec, launches


def trained_memory(pt):
    """The full step's peak memory at MEMORY_BATCHES chunks, with and without
    remat; a line fitted through each mode's peaks predicts the largest batch
    whose peak stays under MEMORY_BUDGET of the card's memory, and that batch
    runs once in each mode (an out-of-memory error there fails the phase)."""
    from spsg_tpu_torch.data import synthetic

    cfg = TrainConfig()
    batch = synthetic.make_chunk_batch(max(MEMORY_BATCHES), cfg.input_dim,
                                       (cfg.style_width, cfg.style_height), seed=7,
                                       with_frames=True, device=DEV)
    batch.pop("name")
    batch["weight_occ"] = np.float32(cfg.weight_occ_loss)
    total = torch.cuda.get_device_properties(0).total_memory
    out, launches = dict(card_bytes=total, budget_share=MEMORY_BUDGET), {}
    for remat in (False, True):
        mode = "remat" if remat else "default"
        c = dataclasses.replace(cfg, remat=remat)
        runs = [memory_step(c, pt, batch, n)[0] for n in MEMORY_BATCHES]
        slope, icpt = np.polyfit([r["batch"] for r in runs],
                                 [r["max_memory_allocated"] for r in runs], 1)
        predicted = int((MEMORY_BUDGET * total - icpt) // slope)
        big, launches[mode] = memory_step(c, pt, batch, predicted)
        big["predicted_peak"] = float(icpt + slope * predicted)
        out[mode] = dict(batches=runs, bytes_per_chunk=float(slope), bytes_fixed=float(icpt),
                         predicted_largest_batch=predicted, largest_batch_run=big)
    return out, launches


def dilated_trainer(src, plain=False, float64=False):
    """:func:`clone_trainer` whose generator has GeneratorConfig.max_dilation
    2 (geo_1d dilated: off the hand kernels), with a fresh Adam."""
    from spsg_tpu_torch.models.generator import Generator

    tr = clone_trainer(src, plain=plain)
    g = Generator(dataclasses.replace(tr.generator.cfg, max_dilation=2),
                  plain_convs=plain).to(src.device)
    g.load_state_dict(src.generator.state_dict())
    tr.generator, tr.optimizer = g, state.gen_optimizer(tr.cfg, g.parameters())
    return float64_library_convs(tr) if float64 else tr


def trained_dilation2():
    """max_dilation 2 on seeded weights: one serving window batch against its
    plain-conv twin (1e-3), and one full step (full_step_fixture(0)) against
    its plain twin (metrics at train2d's rule, the generator's gradients by
    the gradient rule); launches: geo_1d off K1 / K3 / K2."""
    from spsg_tpu_torch.data import synthetic
    from spsg_tpu_torch.models.generator import Generator

    cfg = TrainConfig()
    seeded = seeded_generator(cfg)
    gens = []
    for plain in (False, True):
        g = Generator(dataclasses.replace(seeded.cfg, max_dilation=2), plain_convs=plain).to(DEV)
        g.load_state_dict(seeded.state_dict())
        gens.append(g.eval())
    if [b.route for b in (gens[0].geo_1d, seeded.geo_1d)] != ["library", "hand"]:
        raise SystemExit("chip_smoke: trained: geo_1d's route with max_dilation 2 is not library")
    s = synthetic.make_chunk_batch(8, cfg.input_dim, seed=5)
    x, m = torch.from_numpy(s["input"]).to(DEV), torch.from_numpy(s["mask"]).to(DEV)
    reset_all_launch_counts()
    seconds, diffs, _ = against_plain_twin(gens[0], gens[1], x, m, "max_dilation 2 window batch",
                                           launches=27)
    window_launches = all_launch_counts()
    del gens, seeded, x, m

    batch, base, _ = full_step_fixture(0)
    flags = StepFlags(**FULL_2D)
    tr, twin = dilated_trainer(base), dilated_trainer(base, plain=True)
    yard = dilated_trainer(base, plain=True, float64=True)
    reset_all_launch_counts()
    metrics = tr.step(batch, flags)
    torch.cuda.synchronize()
    step_launches = all_launch_counts()
    if step_launches != WANT_2D_DILATION2:
        raise SystemExit(f"chip_smoke: trained: launches of the max_dilation 2 step "
                         f"{step_launches}, expected {WANT_2D_DILATION2}")
    with plain_raycast_inside():
        twin_metrics = twin.step(batch, flags)
    yard = yardstick_step(yard, batch, flags, True)
    rec = dict(window_batch=dict(chunks=8, forward_seconds=seconds,
                                 kernels_vs_plain_max_abs_diff=diffs, launches=window_launches),
               step=dict(launches_per_step=step_launches,
                         metrics_rel_diff=compare_metrics(metrics, twin_metrics,
                                                          "max_dilation 2 step vs plain twin"),
                         gradient_rule=grad_rule(tr, twin, yard,
                                                 "max_dilation 2 step vs plain twin")))
    del tr, twin, yard
    torch.cuda.empty_cache()
    return rec, window_launches, step_launches


def phase_trained(tmp, smi, scene_rec):
    """Phase trained: the JAX package's trained nf 20 model (its golden
    files, tools/export_torch_goldens.py) served, validated and trained on
    the card; the batch that fits; max_dilation 2. ``scene_rec``: the scene
    phase's record (its seeded-weight figures stand beside the trained
    scene's), or None."""
    from spsg_tpu_torch.cli import test_scene as scene_cli
    from spsg_tpu_torch.inference import whole_scene

    t0 = time.time()
    manifest, gval, gchunked, pt = load_goldens()
    raw = gval["args"]
    rec = dict(nvidia_smi=smi, checkpoint=manifest["checkpoint"], pt=os.path.relpath(pt, REPO),
               golden_jax_seconds=manifest["jax_seconds"])
    paths = {}

    # (1) the chunked CLI with the trained .pt on the golden's scene, float32
    seen = {}
    chunk_dims = tuple(int(d) for d in gchunked["chunk_dims"])
    argv = ["--synthetic_scenes", "1", "--model_path", pt, "--output",
            os.path.join(tmp, "trained_chunked"), "--num_to_vis", "0",
            "--stride", str(int(gchunked["stride"]))]
    if chunk_dims != (128, 64, 64):
        raise SystemExit(f"chip_smoke: trained: the golden's windows are {chunk_dims}")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    with recording_chunked_run(seen) as real_run:
        cli.main(argv)
    paths["trained_chunked"] = all_launch_counts()
    rec["chunked"] = dict(argv=argv, seconds_per_scene=seen["seconds"],
                          max_memory_allocated=torch.cuda.max_memory_allocated(),
                          launches=paths["trained_chunked"],
                          against_jax_golden=compare_chunked_golden(seen["out"], gchunked,
                                                                    "trained chunked scene"))
    print(f"trained: chunked scene against the JAX golden: "
          f"{json.dumps(rec['chunked']['against_jax_golden'])}", flush=True)
    # the same in bf16, against the float32 scene (reported, as the scene phase's bf16)
    cfg = run_config(raw)
    g16 = state.make_generator(dataclasses.replace(cfg, compute_dtype="bfloat16"), DEV)
    g16.load_state_dict(seen["generator"].state_dict())
    out16 = real_run(g16, seen["scene_input"], seen["scene_mask"], *seen["args"], **seen["kwargs"])
    out32 = seen["out"]
    both = (out16.counts > 0) & (out32.counts > 0)
    rec["chunked"]["bfloat16_vs_float32"] = dict(
        counts_agree=float((out16.counts == out32.counts).mean()),
        labels_agree=float((out16.sem_labels == out32.sem_labels).mean()),
        sdf_max_abs_diff=float(np.abs(out16.sdf[both] - out32.sdf[both]).max()),
        geo_iou=out16.geo_intersection / max(out16.geo_union, 1))
    if not (both.any() and np.isfinite(out16.sdf[out16.counts > 0]).all()):
        raise SystemExit("chip_smoke: trained: the bf16 chunked scene is empty or not finite")
    del g16, out16, out32, seen
    torch.cuda.empty_cache()

    # (2) the whole-scene CLI with the trained .pt: seconds, device time, K4's work per ray
    wseen, renders = {}, []
    reset_all_launch_counts()
    t = time.time()
    with recording_scene_cli(wseen, renders) as real_whole:
        scene_cli.main(["--synthetic_scenes", "1", "--model_path", pt, "--output",
                        os.path.join(tmp, "trained_scene")])
    cli_seconds = time.time() - t
    paths["trained_scene"] = all_launch_counts()
    want = {"conv3x3_act_stats": 23, "conv3x3": 5, "conv3x3_dw": 0, "raycast_march": 3,
            "raycast_shade": 3, "raycast_scatter": 0, "raycast_occ": 0, "tsdf_integrate": 0,
            "libconv_dw": 0, **NO_SETUP_DEPTH, "raycast_setup": 3}
    if paths["trained_scene"] != want or len(renders) != 3 or not all(
            np.isfinite(o).all() for o in wseen["out"]):
        raise SystemExit(f"chip_smoke: trained whole scene: launches {paths['trained_scene']}, "
                         f"renders {len(renders)}")
    inp, msk, _ = whole_scene.pad_scene(wseen["scene_input"], wseen["scene_mask"], 3.0,
                                        wseen["kwargs"]["max_height"])
    x, m = torch.from_numpy(inp[None]).to(DEV), torch.from_numpy(msk[None]).to(DEV)
    march_rec, shade_rec = scene_render_kernels(renders[2]["args"], renders[2]["args"][6])
    for r in (march_rec, shade_rec):
        r["grid"] = "trained_scene_prediction"
    work = {k: march_rec[k] for k in ("samples_per_ray", "in_blocks_per_ray", "evaluated_per_ray")}
    seeded = None
    if scene_rec is not None:
        pr = scene_rec["prediction_render"]["raycast_march"]
        seeded = dict(seconds_per_scene=scene_rec["seconds_per_scene"],
                      forward_device_time_ms=scene_rec["forward_device_time"]["total_ms"]
                      if isinstance(scene_rec["forward_device_time"], dict) else None,
                      render_hits=scene_rec["render_hits"], **{
                          k: pr.get(k) for k in ("samples_per_ray", "in_blocks_per_ray",
                                                 "evaluated_per_ray", "ms")})
    rec["scene"] = dict(
        seconds_per_scene=wseen["seconds"], cli_seconds=cli_seconds,
        max_memory_allocated=wseen["forward_peak"], launches=paths["trained_scene"],
        render_seconds={k: r["seconds"] for k, r in zip(("input", "target", "prediction"),
                                                        renders)},
        render_hits={k: r["hits"] for k, r in zip(("input", "target", "prediction"), renders)},
        forward_device_time=profile_forward(wseen["generator"].eval(), x, m),
        prediction_march_per_ray=work, prediction_march_ms=march_rec["ms"],
        prediction_march_bound_ms=march_rec["bound_ms"], prediction_shade_ms=shade_rec["ms"],
        seeded_weights_scene_phase=seeded)
    # the whole scene in bf16 against float32, as the scene phase holds it
    rec["scene"]["bfloat16"], _ = bf16_scene(cfg, wseen, want, real_whole)
    del wseen, x, m
    torch.cuda.empty_cache()

    # (3) the validation pass on the golden's chunks, float32
    trainer = trained_trainer(cfg, pt)
    t = time.time()
    samples = golden_validation_set(cfg, gval)
    set_seconds = time.time() - t
    reset_all_launch_counts()
    t = time.time()
    chunks = port_validation(trainer, gval, samples)
    torch.cuda.synchronize()
    paths["trained_validation"] = all_launch_counts()
    rec["validation"] = dict(seconds=time.time() - t, set_on_cpu_seconds=set_seconds,
                             chunks=len(chunks),
                             launches=paths["trained_validation"],
                             against_jax_golden=compare_val_golden(chunks, gval,
                                                                   "trained validation"))
    val = rec["validation"]["against_jax_golden"]
    print(f"trained: validation against the JAX golden on the card's own views, worst "
          f"{val['worst_rel_diff']:.3e}; every chunk's marches hash to the golden's, "
          f"{sum(sum(c.values()) for c in val['patch_indices_checked'])} patch indices "
          f"checked against the patch values", flush=True)
    del trainer
    torch.cuda.empty_cache()

    # (4) the style run's configuration: bf16 as it ran, float32, float32 with remat
    with open(STYLE_RUN_ARGS) as f:
        raw_style = json.load(f)
    rec["style_run"] = {}
    for mode in ("bfloat16", "float32", "remat"):
        rec["style_run"][mode], paths[f"trained_style_{mode}"] = trained_style_run(
            raw_style, pt, gval, os.path.join(tmp, f"style_{mode}"), mode)
        torch.cuda.empty_cache()
    rec["style_run_cut"] = dict(epochs=[raw_style["max_epoch"] - raw_style["start_epoch"],
                                        STYLE_EPOCHS])

    # (5) the batch that fits, with and without remat
    rec["memory"], mem_launches = trained_memory(pt)
    paths["trained_largest_batch"] = mem_launches["default"]
    paths["trained_largest_batch_remat"] = mem_launches["remat"]

    # (6) max_dilation 2 on seeded weights
    rec["max_dilation_2"], paths["dilation2_window"], paths["dilation2_step"] = trained_dilation2()
    rec["seconds"] = time.time() - t0
    rec["gradient_rule_seconds_so_far"] = RULE_SECONDS[0]
    st = rec["style_run"]
    print("trained: chunked scene against JAX: counts " + f"{rec['chunked']['against_jax_golden']['counts_agree']:.6f}"
          f", sdf {rec['chunked']['against_jax_golden']['sdf_max_abs_diff']:.3e}; validation worst "
          f"{rec['validation']['against_jax_golden']['worst_rel_diff']:.3e}; K4 per ray {work}"
          f" (seeded: {seeded}); style run s/iteration " + ", ".join(
              f"{k} {v['seconds_per_iteration'].get('full', {}).get('median')} peak "
              f"{v['max_memory_allocated']}" for k, v in st.items())
          + "; largest batch " + ", ".join(
              f"{k} {rec['memory'][k]['predicted_largest_batch']} (peak "
              f"{rec['memory'][k]['largest_batch_run']['max_memory_allocated']})"
              for k in ("default", "remat")) + f"; {smi}; phase {rec['seconds']:.1f} s",
          flush=True)
    emit("trained", **rec)
    return paths, (march_rec, shade_rec)


# --------------------------------------------------------------------------- parallel
PAR_WORLD = 2
# the train CLI's few iterations: 4 chunks in global batches of 2 (one a rank),
# the full step from the first iteration
PAR_CLI_ARGS = ["--synthetic_chunks", "4", "--max_epoch", "1", "--num_iters_geo_only", "0",
                "--no_vis"]
# the kernels each parallel path must launch (the counts of both ranks, summed)
PAR_PATHS = {"parallel_train": CONV_KERNELS + ("libconv_dw",),
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

    for seed in WITNESS_SEEDS:  # seed 0's step is the parallel_train path; 1, 2 for the rule
        d = torch.load(os.path.join(directory, f"train{seed}.pt"), weights_only=False)
        trainer = Trainer(TrainConfig(), device, seed=0, mesh=mesh)
        trainer.generator.load_state_dict(d["generator"])
        trainer.discriminator.load_state_dict(d["discriminator"])
        trainer.sn_state = {k: {kk: vv.to(device) for kk, vv in v.items()}
                            for k, v in d["sn_state"].items()}
        batch = shard_batch(d["batch"], mesh)
        metrics = rank_part(rec, "train" if seed == 0 else f"train_seed{seed}",
                            lambda: trainer.step(batch, StepFlags(**FULL_2D)))
        if seed == 0:
            out["metrics"] = {k: float(v) for k, v in metrics.items()}
            out["disc_grads"] = {n: p.grad.cpu()
                                 for n, p in trainer.discriminator.named_parameters()}
            out["params"] = {k: v.cpu() for k, v in trainer.generator.state_dict().items()}
        out[f"grads{seed}"] = {n: p.grad.cpu() for n, p in trainer.generator.named_parameters()}
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
    backend = parallel_backend()
    print(f"parallel: {PAR_WORLD} ranks, backend {backend} "
          f"({'a card each' if backend == 'nccl' else 'both on one card'}); {smi}", flush=True)
    cfg = TrainConfig()
    for seed in WITNESS_SEEDS:
        batch, base, _ = full_step_fixture(seed)
        torch.save(dict(batch=batch,
                        generator={k: v.cpu() for k, v in base.generator.state_dict().items()},
                        discriminator={k: v.cpu()
                                       for k, v in base.discriminator.state_dict().items()},
                        sn_state={k: {kk: vv.cpu() for kk, vv in v.items()}
                                  for k, v in base.sn_state.items()}),
                   os.path.join(par, f"train{seed}.pt"))
    # the rule's references and yardsticks on the three seeds, before the ranks
    # take the card (cached if the witness of conv_forms ran)
    refs = {seed: (full_step_grads("default", seed), full_step_grads("yard_default", seed))
            for seed in WITNESS_SEEDS}
    batch, base, _ = full_step_fixture(0)
    trainer = clone_trainer(base)
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
    for k in ("disc_grads", "params") + tuple(f"grads{seed}" for seed in WITNESS_SEEDS):
        if not all(torch.equal(v, r1[k][n]) for n, v in r0[k].items()):
            raise SystemExit(f"chip_smoke: parallel: the ranks' {k} differ")
    two = on_cpu({"generator": r0["grads0"], "discriminator": r0["disc_grads"]})
    train_rec = dict(metrics_rel_diff=compare_metrics(r0["metrics"], metrics,
                                                      "parallel train step"))
    # the generator's gradients by the gradient rule on the three seeds: this
    # process's default step the reference (seed 0: the step above)
    train_rec["gradient_rule"] = {
        seed: grad_rule(r0[f"grads{seed}"], one if seed == 0 else refs[seed][0], refs[seed][1],
                        f"parallel train step, seed {seed}") for seed in WITNESS_SEEDS}
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


# --------------------------------------------------------------------------- libconv_dw
# the generator's seven library convs at nf 20 on (128,64,64) chunks:
# (input extent, Cin, Cout, kernel, stride, padding)
LIBCONV_LAYERS = {
    "geo_0a": ((128, 64, 64), 1, 10, 5, 1, 2),
    "geo_0b": ((128, 64, 64), 10, 20, 4, 2, 1),
    "geo_1a": ((64, 32, 32), 20, 40, 4, 2, 1),
    "encoder_0a": ((128, 64, 64), 4, 20, 5, 1, 2),
    "encoder_0b": ((128, 64, 64), 20, 40, 4, 2, 1),
    "encoder_geo": ((128, 64, 64), 20, 20, 4, 2, 1),
    "encoder_1a": ((64, 32, 32), 60, 100, 4, 2, 1),
}


# shapes off the generator's path: ragged tiles, a tail chunk of input channels,
# Cout split over blocks, a 3^3 stride-2 conv, and inputs at an odd address
LIBCONV_EDGES = {
    "ragged_5": ((13, 21, 19), 3, 7, 5, 1, 2),
    "tail_chunk_split_cout": ((10, 18, 22), 7, 100, 4, 2, 1),
    "odd_3_stride2": ((9, 9, 9), 5, 9, 3, 2, 1),
    "unaligned": ((16, 20, 24), 4, 20, 4, 2, 1),
}


def libconv_dw_layer(name, batch, gen):
    """One library conv's weight gradient at ``batch``: the kernel against the
    library's in true float32 and in float64, two calls, times."""
    dims, cin, cout, k, s, p = {**LIBCONV_LAYERS, **LIBCONV_EDGES}[name]
    out = tuple((n + 2 * p - k) // s + 1 for n in dims)
    if name == "unaligned":  # contiguous views one float past an aligned start
        x = torch.randn(batch * math.prod(dims) * cin + 1, device="cuda", generator=gen)
        dy = torch.randn(batch * math.prod(out) * cout + 1, device="cuda", generator=gen)
        x, dy = x[1:].view((batch,) + dims + (cin,)), dy[1:].view((batch,) + out + (cout,))
    else:
        x = torch.randn((batch,) + dims + (cin,), device="cuda", generator=gen)
        dy = torch.randn((batch,) + out + (cout,), device="cuda", generator=gen)
    got = libconv_ops.libconv_dw(x, dy, k, s, p)
    again = libconv_ops.libconv_dw(x, dy, k, s, p)
    ref = libconv_ops.libconv_dw_plain(x, dy, k, s, p)
    ref64 = None
    if batch == 2:  # cuDNN's float64 wgrad takes seconds a layer at batch 8
        ref64 = torch.nn.grad.conv3d_weight(x.double().permute(0, 4, 1, 2, 3), tuple(ref.shape),
                                            dy.double().permute(0, 4, 1, 2, 3), s, p)
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    abs_err = (got - ref).abs().max().item()
    flops = 2.0 * k ** 3 * cin * cout * batch * math.prod(out)
    nbytes = 4.0 * (x.numel() + dy.numel() + got.numel())
    t_ops, t_bytes = PASSES[torch.float32] * flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    rec = dict(layer=name, batch=batch, x=list(x.shape), dy=list(dy.shape), kernel=k, stride=s,
               padding=p, max_rel_err=err, max_abs_err=abs_err,
               max_rel_err_float64="not measured" if ref64 is None else
               ((got.double() - ref64).abs().max() / ref64.abs().max()).item(),
               library_max_rel_err_float64="not measured" if ref64 is None else
               ((ref.double() - ref64).abs().max() / ref64.abs().max()).item(),
               bit_equal=bool(torch.equal(got, again)),
               ms=cuda_ms(lambda: libconv_ops.libconv_dw(x, dy, k, s, p), 10),
               library_ms=cuda_ms(lambda: libconv_ops.libconv_dw_plain(x, dy, k, s, p), 3),
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    if not (err <= 1e-4 and rec["bit_equal"] and torch.isfinite(got).all()):
        raise SystemExit(f"chip_smoke: libconv_dw at {name}, batch {batch}: {rec}")
    return rec


def libconv_dw_launches(remat):
    """Kernel launches and the counter train.libconv_dw of one train forward
    and backward of the nf-20 generator at batch 2."""
    gen = tg_models.Generator(tg_models.GeneratorConfig(remat=remat)).cuda().train()
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand((2, 128, 64, 64, 4), device="cuda", generator=g) * 6 - 3
    m = (torch.rand((2, 128, 64, 64, 1), device="cuda", generator=g) > 0.5).float()
    libconv_ops.reset_launch_counts()
    timing.drain()  # what the profiled phases before this one left in the record
    timing.enable()
    try:
        outs = gen(x, m, **FULL_3D)
        sum((o.float() ** 2).mean() for o in outs).backward()
        torch.cuda.synchronize()
    finally:
        timing.disable()
    counted = timing.drain()["counts"].get("train.libconv_dw", 0)
    launches = libconv_ops.launch_counts["libconv_dw"]
    if not launches == counted == 7:
        raise SystemExit(f"chip_smoke: libconv_dw: {launches} launches, counter {counted}, "
                         f"remat {remat}; want 7 and 7")
    return dict(remat=remat, launches=launches, counter=counted)


def phase_libconv_dw():
    use_true_float32()
    hmma = _build.sass_summary("conv3x3_dw")
    variants = {k: v for k, v in hmma.items() if "libconv_dw_kernel" in k} \
        if "error" not in hmma else {}
    if "error" not in hmma and (not variants or not all(v > 0 for v in variants.values())):
        raise SystemExit(f"chip_smoke: libconv_dw_kernel variants without HMMA: "
                         f"{[k for k, v in variants.items() if not v > 0] or 'none built'}")
    gen = torch.Generator(device="cuda").manual_seed(24)
    layers = [libconv_dw_layer(name, batch, gen) for batch in (2, 8) for name in LIBCONV_LAYERS]
    totals = {b: {k: sum(r[k] for r in layers if r["batch"] == b)
                  for k in ("ms", "library_ms", "bound_ms")} for b in (2, 8)}
    edges = [libconv_dw_layer(name, 2, gen) for name in LIBCONV_EDGES]
    emit("libconv_dw", hmma=variants if "error" not in hmma else "not measured",
         layers=layers, totals_by_batch=totals, edges=edges,
         launches=[libconv_dw_launches(False), libconv_dw_launches(True)])
    return dict(layers=layers, edges=edges, totals_by_batch=totals)


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
    ap.add_argument("--baseline-port-source", default=None,
                    help="another version's spsg_tpu_torch/ops directory: its march_setup and "
                         "depth_to_normals timed beside this one's")
    ap.add_argument("--phases", type=lambda v: v.split(","), default=None,
                    help="comma-separated phases to run (default: every phase); device and "
                         "build always run, and a phase takes along the phases whose outputs "
                         "it reads: " + ", ".join(PHASES))
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


# the phases --phases selects from, in the order they run (device and build always
# run); a phase that reads another's outputs takes it along (NEEDS)
PHASES = ("compare", "compare_raycast", "path", "scene", "metrics", "train", "train2d",
          "train2d_style", "train2d_bf16", "conv_forms", "train_cli", "datagen", "parallel",
          "trained", "libconv_dw")
NEEDS = {"metrics": ("scene",), "conv_forms": ("scene",), "parallel": ("path", "scene")}


def selected_phases(names):
    """The phases to run for --phases ``names`` (all by default), with what
    they need, in PHASES' order."""
    want = set(PHASES if names is None else names)
    unknown = want - set(PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}; the phases: {PHASES}")
    for name in list(want):
        want.update(NEEDS.get(name, ()))
    return [p for p in PHASES if p in want]


def run_phases(args, par):
    run = selected_phases(args.phases)
    smi = phase_device()
    phase_build()
    for key, src in (("conv3x3", args.baseline_source),
                     ("conv3x3_dw", args.baseline_dw_source),
                     ("raycast", args.baseline_raycast_source),
                     ("tsdf", args.baseline_tsdf_source)):
        if src:
            BASELINE[key] = load_baseline(src, key)
    if args.baseline_port_source:
        BASELINE["port"] = load_baseline_port(args.baseline_port_source)
    results = phase_compare() if "compare" in run else None
    rc_results = phase_compare_raycast() if "compare_raycast" in run else None
    # launches by path, each counter set to 0 just before the path's run
    by_path, scene_rec, tsdf_rec = {}, None, None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as tmp:
        if "path" in run:
            by_path["serve"] = phase_path(tmp, par)
        if "scene" in run:
            by_path["scene"], scene_rec = phase_scene(tmp, rc_results, par)
        if "metrics" in run:
            phase_metrics(tmp, os.path.join(tmp, "scene"))
    if "train" in run:
        by_path["train"] = phase_train()
    train2d_device = "not measured in this run (phase train2d did not run)"
    if "train2d" in run:
        by_path["train2d"], by_path["train2d_missing_colour"], train2d_device = phase_train2d()
    if "train2d_style" in run:
        by_path["train2d_style"] = phase_train2d_style()
    if "train2d_bf16" in run:
        by_path["train2d_bf16"] = phase_train2d_bf16(train2d_device)
    if "conv_forms" in run:
        by_path.update(phase_conv_forms(par))
    if "train_cli" in run:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as tmp:
            by_path["train_cli"] = phase_train_cli(tmp, smi)
    if "datagen" in run:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as tmp:
            by_path["datagen"], tsdf_rec = phase_datagen(tmp)
    if "parallel" in run:
        by_path.update(phase_parallel(par, smi))
    if "trained" in run:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as tmp:
            trained_paths, trained_renders = phase_trained(tmp, smi, scene_rec)
        by_path.update(trained_paths)
        if rc_results is not None:
            rc_results["raycast_march"].append(trained_renders[0])
            rc_results["raycast_shade"].append(trained_renders[1])
    libconv_rec = phase_libconv_dw() if "libconv_dw" in run else None
    print(f"gradient rule: its yardstick steps took {RULE_SECONDS[0]:.1f} s", flush=True)

    # the kernels of each path: serving runs the two forward kernels, the 3D
    # training step all three conv kernels and the library convs' dW, the full
    # step (with style / content too) all but the occupancy march, which only the
    # missing-colour weights run; in bf16 and with zslab_conv the full step but the
    # library convs' dW; the train CLI as the full step; datagen the TSDF
    # integrate; the trained model's validation pass the forward kernels and the
    # renders
    training = tuple(k for k in KERNELS if k != "tsdf_integrate")
    full_step = tuple(k for k in training if k != "raycast_occ")
    library_dw = tuple(k for k in full_step if k != "libconv_dw")
    forward = ("conv3x3", "conv3x3_act_stats")
    rendered = forward + ("raycast_setup", "raycast_march", "raycast_shade")
    on_path = {"serve": forward, "scene": rendered, "train": CONV_KERNELS + ("libconv_dw",),
               "train2d": full_step, "train2d_missing_colour": training,
               "train2d_style": full_step, "train2d_bf16": library_dw, "train_cli": full_step,
               "datagen": ("tsdf_integrate",), **PAR_PATHS,
               "trained_chunked": forward, "trained_scene": rendered,
               "trained_validation": rendered + DEPTH_KERNELS, "dilation2_window": forward,
               "dilation2_step": full_step}
    for path in by_path:
        if path in ("train2d_zslab_conv", "trained_style_bfloat16"):
            on_path[path] = library_dw
        elif path.startswith(("train2d_folded", "train2d_remat", "trained_style_",
                              "trained_largest_batch")):
            on_path[path] = full_step
        elif path.startswith("scene_"):
            on_path[path] = forward
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        launches = {path: counts[name] for path, counts in by_path.items()}
        for path, counts in by_path.items():
            if name in on_path[path] and counts[name] < 1:
                raise SystemExit(f"chip_smoke: {name} was not launched on the {path} path")
        head, measured_at, detail, recs = None, None, {}, None
        if name in CONV_KERNELS and results is not None:
            recs = results[name]["float32"]
            head = next(r for r in recs if (r["shape"], r["cin"], r["cout"])
                        == (list(HEAVIEST[:4]), HEAVIEST[4], HEAVIEST[5]))
            measured_at = dict(shape=head["shape"], cin=head["cin"], cout=head["cout"],
                               dtype="float32")
            detail = dict(dtypes=results[name])
        elif name == "tsdf_integrate" and tsdf_rec is not None:
            recs = [tsdf_rec]
            head = tsdf_rec
            measured_at = dict(grid=head["grid"], image=head["image"], dtype="float32",
                               frames=len(head["frames"]))
            detail = dict(frames=head["frames"])
        elif name in SETUP_DEPTH_KERNELS and rc_results is not None:
            recs = rc_results[name]
            head = next(r for r in recs if r["main_path"])
            measured_at = dict(case=head["case"], shape=head["shape"], dtype="float32")
            detail = dict(cases=recs)
        elif name in RAYCAST_KERNELS and rc_results is not None:
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
        elif name == "libconv_dw" and libconv_rec is not None:
            # all seven library convs at the training batch, summed; the plain
            # version is the library's weight gradient
            recs = libconv_rec["layers"] + libconv_rec["edges"]
            b2 = libconv_rec["totals_by_batch"][2]
            head = dict(ms=b2["ms"], plain_ms=b2["library_ms"], library_ms=b2["library_ms"],
                        bound_ms=b2["bound_ms"], bound_by="operations" if all(
                            r["bound_by"] == "operations" for r in libconv_rec["layers"]
                            if r["batch"] == 2) else "operations and bytes")
            measured_at = dict(layers=list(LIBCONV_LAYERS), batch=2, dtype="float32",
                               summed=True)
            detail = dict(cases=recs, totals_by_batch=libconv_rec["totals_by_batch"])
        numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launches.values()), launches_by_path=launches,
            **({k: None for k in numbers} if head is None else dict(
                max_abs_err=max(r["max_abs_err"] for r in recs), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"])),
            measured_at=measured_at or "not measured in this run (its compare phase did not run)",
            **detail))
    print(smi, flush=True)  # again, so that it stands near the result whatever was printed above
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

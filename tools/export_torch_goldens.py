#!/usr/bin/env python
"""Golden files of a checkpoint trained with the JAX package, for the
PyTorch port on a machine without jax: the weights as the port's ``.pt``
and what the JAX package computes with them, in float32, on inputs that the
port can make again from the same seeds.

    JAX_PLATFORMS=cpu python tools/export_torch_goldens.py \\
        docs/evidence/bench_r4/curriculum_run/model-epoch59 docs/evidence/torch_port/epoch59

writes into the output directory:

  model-epoch<N>.pt   ``tools/export_torch_checkpoint.export`` of the checkpoint
                      (generator, discriminator, spectral state; no Adam moments)
  golden_val.json     the JAX package's validation pass (``Trainer.step`` with
                      ``StepFlags.for_iter(iteration, cfg, have_frames=True,
                      train=False)`` without style / content, float32, the
                      views of precompute_views) on the run's own validation set,
                      the train CLI's ``SyntheticChunkDataset(max(2,
                      synthetic_chunks // 8), cfg, True, seed=2)``, one chunk a
                      step: every metric per chunk and their mean; the run's
                      ``args.txt``; a sha256 of each chunk's frame
  golden_chunked.npz  ``run_chunked_inference`` with these weights on the
                      chunked CLI's synthetic scene (``make_scene(seed=100)``
                      of the CLI's scene size): labels, overlap counts and
                      occupancy of every voxel; SDF and colour at the voxels
                      with a prediction (the truncation band) and at a seeded
                      sample of all voxels, in flat order; IoU and mIoU
  MANIFEST.json       sha256 and size of each file, the command, the seconds
                      each golden took, the checkpoint directory

The run's configuration comes from the ``args.txt`` beside the checkpoint
(the JAX train CLI's flags), with ``compute_dtype`` set to float32. The
iteration of the curriculum is the checkpoint's: its epoch times the
iterations of an epoch. The chunked scene's windows overlap by a stride of
32. The format of the files (frame and march digests, the manifest) is
``spsg_tpu_torch/utils/goldens.py``. Needs jax, flax and orbax, and takes
minutes at nf_gen 20 and (128,64,64) on a CPU (``MANIFEST.json`` holds the
seconds).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from spsg_tpu_torch.utils.goldens import (  # noqa: E402
    FRAME_KEYS, MARCH_DIGEST_KEYS, MARCH_KEYS, array_digest, frame_digest, manifest_files,
    replay_args)

# voxels of the chunked scene whose SDF and colour are kept besides the band
SAMPLE_VOXELS = 20000
# windows a forward in the chunked scene (memory only: the outputs do not depend on it)
WINDOW_BATCH = 1


def run_args(args_txt: str) -> dict:
    with open(args_txt) as f:
        return json.load(f)


def run_config(raw: dict):
    """The JAX package's TrainConfig of the run that wrote ``raw`` (its
    args.txt), computing in float32."""
    from spsg_tpu.cli import train as jax_train_cli

    ns = replay_args(jax_train_cli.build_parser(), raw)
    return dataclasses.replace(jax_train_cli.config_from_args(ns), compute_dtype=None)


def export_and_restore(checkpoint: str, pt: str, cfg):
    """``export_torch_checkpoint.export`` of ``checkpoint`` into ``pt``, and
    the JAX states that its restore returned: (gen_state, disc_state, epoch).
    One orbax restore serves the .pt and the goldens: export takes
    ``load_checkpoint`` from ``spsg_tpu.training.state`` when it runs, and
    this keeps what it returns."""
    from export_torch_checkpoint import export
    from spsg_tpu.training import state as jax_state

    load, restored = jax_state.load_checkpoint, []

    def keep(*args):
        restored.append(load(*args))
        return restored[-1]

    jax_state.load_checkpoint = keep
    try:
        export(checkpoint, pt, cfg)
    finally:
        jax_state.load_checkpoint = load
    return restored[0]


def scene_dims(chunk_dims):
    """The chunked CLI's synthetic scene for its window size."""
    return (chunk_dims[0], chunk_dims[1] * 5 // 2, chunk_dims[2] * 3)


def port_frames(cfg, seed):
    """The frame of the port's synthetic chunk ``seed`` (the train CLI's
    SyntheticChunkDataset on the CPU), as numpy arrays with a batch axis."""
    from spsg_tpu_torch.data import synthetic as port_synthetic

    b = port_synthetic.make_chunk_batch(1, cfg.input_dim, (cfg.style_width, cfg.style_height),
                                        seed=seed, with_frames=True, truncation=cfg.truncation,
                                        device="cpu")
    return b, {k: b[k] for k in FRAME_KEYS}


# a view value is patched where the packages are further apart than this, relative
# to max(1, |value|): a depth by a hit that flips (not its ulps), a normal of the
# depth chain by more than 1e-4 (ROADMAP.md Queue C: 8.6e-6 at 16^3)
PATCH_TOL = {"in_depth": 1e-6, "tgt_depth": 1e-6, "images_normals": 1e-4}


def march_patches(jax_views, port_views):
    """Where the JAX package's views (its precompute_views) differ from the
    port's on the CPU: per key of MARCH_KEYS and images_normals the flat
    indices and the JAX values there (a hit or its voxel that differs; a
    float beyond PATCH_TOL); how far the normals are apart at most."""
    patches = {}
    for k in MARCH_KEYS + ("images_normals",):
        a = np.asarray(jax_views[k]).reshape(-1)
        b = port_views[k].numpy().reshape(-1)
        if a.dtype.kind == "f":
            differ = (np.abs(a - b) > PATCH_TOL[k] * np.maximum(1.0, np.abs(a))) | (
                np.isnan(a) != np.isnan(b))
        else:
            differ = a != b
        idx = np.flatnonzero(differ)
        patches[k] = [idx.tolist(), a[idx].tolist()]
    normals = np.abs(np.asarray(jax_views["images_normals"]) - port_views["images_normals"].numpy())
    return patches, float(np.nanmax(normals))


def golden_val(cfg, raw, gen_state, disc_state, iteration):
    """The JAX package's validation pass on the run's validation set, one
    chunk a step. The two raycasters round the march apart (ROADMAP.md Queue
    C, the plain march against XLA's): their renders differ by an ulp on a share of the pixels and by a
    flipped hit on a few, which moves the 2D and adversarial metrics by more
    than the pass's own rounding (1.7e-3 of the discriminator's loss on chunk
    0). So both sides get the same views: each chunk's frame is the port's
    rendering of it on the CPU (the train CLI's SyntheticChunkDataset with
    device="cpu"), and the step takes the input and target marches and the
    depth chain from precompute_views (``precomp``), the JAX package's own;
    where its marches differ from the port's (on the CPU, here) the chunk
    records those pixels' JAX values (march_patches), which the port's run
    writes into its own precompute_views. The chunks' volumes are the same in
    both packages (checked here); each chunk records its frame's sha256, the
    sha256 of the JAX marches' hits and voxels, and how many of the JAX
    package's own frame values are more than 1e-5 from the port's."""
    import jax

    from spsg_tpu.cli.train import SyntheticChunkDataset
    from spsg_tpu.training import StepFlags
    from spsg_tpu.training.loop import _prepare_batch
    from spsg_tpu.training.step import Trainer

    from spsg_tpu_torch.cli.train import config_from_args as port_config_from_args
    from spsg_tpu_torch.cli.train import build_parser as port_parser
    from spsg_tpu_torch.training.step import Trainer as PortTrainer

    n = max(2, raw["synthetic_chunks"] // 8)
    ds = SyntheticChunkDataset(n, cfg, True, seed=2)
    ns = replay_args(port_parser(), raw)
    port_trainer = PortTrainer(dataclasses.replace(port_config_from_args(ns), compute_dtype=None),
                               "cpu")
    # without the style / content terms, which the JAX step computes only with a
    # VGG (no pretrained weights in the repository; the nf-20 run has neither)
    flags = dataclasses.replace(StepFlags.for_iter(iteration, cfg, have_frames=True, train=False),
                                compute_style=False, compute_content=False)
    trainer = Trainer(cfg)
    chunks = []
    for i in range(len(ds)):
        sample = ds[i]
        batch = {k: v[None] for k, v in sample.items() if isinstance(v, np.ndarray)}
        port, frames = port_frames(cfg, 2 * 100000 + i)
        volumes_equal = all(np.array_equal(v, port[k]) for k, v in batch.items()
                            if k not in FRAME_KEYS and k in port)
        if not volumes_equal:
            raise SystemExit(f"export_torch_goldens: chunk {i}: the packages' volumes differ")
        jax_differing = {k: int((np.abs(batch[k] - frames[k]) > 1e-5).sum()) for k in FRAME_KEYS}
        batch.update(frames)
        batch = _prepare_batch(batch, cfg, iteration)
        views = jax.device_get(trainer.precompute_views(batch))
        patches, normals_apart = march_patches(views, port_trainer.precompute_views(batch))
        _, _, metrics = trainer.step(gen_state, disc_state, batch, jax.random.PRNGKey(0), flags,
                                     precomp=views, donate=False)
        chunks.append(dict(name=sample["name"], frame_sha256=frame_digest(frames),
                           jax_frame_values_off_by_over_1e5=jax_differing,
                           march_patches=patches,
                           march_sha256={k: array_digest(views[k]) for k in MARCH_DIGEST_KEYS},
                           normals_max_abs_diff=normals_apart,
                           metrics={k: float(v) for k, v in jax.device_get(metrics).items()}))
    keys = chunks[0]["metrics"]
    return dict(iteration=iteration, flags=dataclasses.asdict(flags), args=raw,
                validation_set=dict(chunks=n, seed=2, frames="the port's, rendered on the CPU"),
                dtype="float32", chunks=chunks,
                mean={k: float(np.mean([c["metrics"][k] for c in chunks])) for k in keys})


def golden_chunked(cfg, gen_state, stride, seed=100):
    from spsg_tpu.data import pipeline, synthetic
    from spsg_tpu.inference import chunked
    from spsg_tpu.training.state import make_generator

    dims = scene_dims(cfg.input_dim)
    s = synthetic.make_scene(dims=dims, seed=seed)
    sample = pipeline.assemble_sample(s.sdf_input, s.sdf_complete, s.input_colors, s.colors,
                                      s.semantics, s.known, s.world2grid, cfg.truncation,
                                      cfg.color_space, None)
    variables = {"params": gen_state.params, "batch_stats": gen_state.batch_stats}
    out = chunked.run_chunked_inference(
        make_generator(cfg), variables, sample["input"], sample["mask"], sample["target_sdf"],
        sample.get("known"), sample.get("semantics"), truncation=cfg.truncation,
        chunk_dims=tuple(cfg.input_dim), stride=stride, window_batch=WINDOW_BATCH,
        pred_color=cfg.weight_color_loss > 0, pred_semantic=cfg.weight_semantic_loss > 0)
    summary = chunked.summarize_iou(out.geo_intersection, out.geo_union,
                                    out.class_intersection, out.class_union, out.class_weight)
    rng = np.random.default_rng(seed)
    sample_idx = np.sort(rng.choice(out.counts.size, min(SAMPLE_VOXELS, out.counts.size),
                                    replace=False)).astype(np.int32)
    # the voxels with a prediction (the band) and the sample, in flat order: the
    # order of the sdf and colors entries (the counts give the band)
    idx = np.union1d(np.flatnonzero(out.counts > 0), sample_idx)
    if out.counts.max() > 255:
        raise SystemExit("export_torch_goldens: overlap counts do not fit uint8")
    return dict(
        scene_dims=np.asarray(dims), chunk_dims=np.asarray(cfg.input_dim), stride=stride,
        window_batch=WINDOW_BATCH, scene_seed=seed, truncation=cfg.truncation,
        counts=out.counts.astype(np.uint8), occ=np.packbits(out.occ.astype(bool)),
        sem_labels=out.sem_labels.astype(np.uint8), sample_voxels=sample_idx,
        sdf=out.sdf.reshape(-1)[idx].astype(np.float32),
        colors=out.colors.reshape(-1, 3)[idx].astype(np.uint8),
        geo_intersection=out.geo_intersection, geo_union=out.geo_union,
        class_intersection=out.class_intersection, class_union=out.class_union,
        class_weight=out.class_weight, geo_iou=summary["geo_iou"],
        mean_iou=summary["mean_iou"])


def write_goldens(checkpoint, out_dir, stride=32):
    """Write the four files into ``out_dir``, the chunked scene's windows
    ``stride`` apart; returns the manifest."""
    import jax

    args_txt = os.path.join(os.path.dirname(os.path.abspath(checkpoint)), "args.txt")
    raw = run_args(args_txt)
    cfg = run_config(raw)
    os.makedirs(out_dir, exist_ok=True)
    seconds = {}

    t = time.time()
    name = os.path.basename(os.path.normpath(checkpoint))
    gen_state, disc_state, epoch = export_and_restore(
        checkpoint, os.path.join(out_dir, f"{name}.pt"), cfg)
    seconds["pt"] = time.time() - t
    iteration = int(epoch) * (raw["synthetic_chunks"] // raw["batch_size"])

    t = time.time()
    val = golden_val(cfg, raw, gen_state, disc_state, iteration)
    with open(os.path.join(out_dir, "golden_val.json"), "w") as f:
        json.dump(val, f, indent=1)
    seconds["golden_val"] = time.time() - t

    t = time.time()
    np.savez_compressed(os.path.join(out_dir, "golden_chunked.npz"),
                        **golden_chunked(cfg, gen_state, stride))
    seconds["golden_chunked"] = time.time() - t

    manifest = dict(
        checkpoint=os.path.relpath(os.path.abspath(checkpoint), REPO), epoch=int(epoch),
        args_txt=os.path.relpath(args_txt, REPO),
        command=f"JAX_PLATFORMS=cpu python tools/export_torch_goldens.py {checkpoint} {out_dir}",
        jax_seconds=seconds, jax_platform=jax.default_backend(), jax_version=jax.__version__,
        cpu_count=os.cpu_count(), iteration=iteration, stride=stride,
        window_batch=WINDOW_BATCH, scene_dims=list(scene_dims(cfg.input_dim)),
        files=manifest_files(out_dir))
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", help="orbax checkpoint directory (model-epochN), its run's "
                                      "args.txt beside it")
    p.add_argument("out_dir", help="directory to write the .pt and the golden files into")
    args = p.parse_args(argv)
    print(json.dumps(write_goldens(args.checkpoint, args.out_dir), indent=1))


if __name__ == "__main__":
    main()

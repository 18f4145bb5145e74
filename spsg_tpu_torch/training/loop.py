"""Host-side training loop (PyTorch counterpart of
``spsg_tpu/training/loop.py``; reference torch/train.py:399-867, 1278-1323):
epoch iteration, curriculum flags, CSV logging, checkpoints, validation,
visual dumps, phase timing and the render cache.

Multi-process (``mesh=`` of ``parallel.make_mesh()``, one process a device,
``parallel/multihost.py``): each rank feeds its interleaved slice of every
global batch (``multihost.local_indices``), the step's collectives make its
reductions global, the skip decisions and the preemption stop are agreed
across ranks, and only the primary rank writes logs, checkpoints and visual
dumps; the render cache stays per rank (a rank caches the views of its own
samples). Not carried over: ``steps_per_call``, which only batches XLA
dispatches.
"""

from __future__ import annotations

import os
import signal
import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..data.pipeline import batch_iterator
from ..parallel import mesh as pmesh
from ..parallel import multihost
from ..utils.logging import MetricsAccumulator, TrainLog
from ..utils.timing import PhaseTimer
from . import state as state_lib
from .config import StepFlags, TrainConfig
from .step import Trainer

# what Trainer.precompute_views reads (RenderCache gathers only these)
_PRECOMPUTE_INPUTS = ("input", "target_sdf", "images_depth", "images_view", "images_intrinsic")


def _prepare_batch(batch, cfg: TrainConfig, it: int):
    batch = dict(batch)
    batch.pop("name", None)
    batch.pop("frames_missing", None)
    batch.pop("frame_ids", None)  # cache key only (RenderCache), not a tensor
    # curriculum occ weight (train.py:476)
    w = 1.0 if it <= cfg.num_iters_geo_only else cfg.weight_occ_loss
    batch["weight_occ"] = np.asarray(w, np.float32)
    return batch


def _has_frames(batch) -> bool:
    return "images_depth" in batch and "images_color" in batch


def _to_host(metrics):
    """A step's metrics as Python floats, read back in one transfer."""
    keys = list(metrics)
    values = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


class RenderCache:
    """LRU over :meth:`Trainer.precompute_views` results on the trainer's
    device, keyed per sample by (chunk name, selected frame ids).

    The input and target marches and the depth chain depend on the batch
    alone, yet the reference recomputes them every step (train.py:563,590);
    a chunk revisited with the same frames reuses them, with the same losses
    to the bit. Entries are (F, ...) slices of a precompute; a batch's entries
    go to :meth:`Trainer.step` as a tuple, which concatenates them."""

    def __init__(self, trainer: Trainer, capacity: int):
        self.trainer = trainer
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self._d: "OrderedDict" = OrderedDict()

    def lookup(self, batch, names, frame_ids):
        """Per-sample precomp entries for this batch (tuple, len B).

        Hits and misses are per sample: only the missing samples are
        recomputed, as one sub-batch gathered from the tensors
        ``precompute_views`` reads. No sample's entries depend on another's
        (the depth chain runs per frame), so the sub-batch gives the same
        entries to the bit as any other batch holding the sample."""
        B = len(names)
        if frame_ids is None:
            frame_ids = [()] * B
        keys = [(n, tuple(np.asarray(f).ravel().tolist())) for n, f in zip(names, frame_ids)]
        missing = [i for i, k in enumerate(keys) if k not in self._d]
        self.hits += B - len(missing)
        self.misses += len(missing)
        if missing:
            sub = {k: batch[k][missing] for k in _PRECOMPUTE_INPUTS if k in batch}
            pre = self.trainer.precompute_views(sub)
            F = pre["frames_ok"].shape[0] // len(missing)
            for j, i in enumerate(missing):
                self._d[keys[i]] = {k: v[j * F:(j + 1) * F] for k, v in pre.items()}
        for k in keys:
            self._d.move_to_end(k)
        out = tuple(self._d[k] for k in keys)  # before eviction: capacity < B
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
        return out


def _dump_visuals(trainer: Trainer, cfg: TrainConfig, batch, it, epoch, save_dir, flags):
    """Mesh / PNG dumps of the current batch's predictions (reference
    save_predictions call, train.py:842-849), eval-mode BatchNorm."""
    from ..utils import visualize

    gen = trainer.generator
    was_training = gen.training
    gen.eval()
    try:
        with torch.no_grad():
            occ_l, sdf_p, color_p, sem_p = gen(
                batch["input"], batch["mask"], pred_color=flags.pred_color, pred_sdf=True,
                pred_semantic=flags.pred_semantic)
    finally:
        gen.train(was_training)

    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    occ = 1.0 / (1.0 + np.exp(-host(occ_l)[..., 0])) > 0.5
    sdf_p, color_p, sem_p = host(sdf_p)[..., 0], host(color_p), host(sem_p)
    inp, tgt = host(batch["input"]), host(batch["target_sdf"])
    tgt_colors, sems = host(batch.get("target_colors")), host(batch.get("semantics"))
    out_dir = os.path.join(save_dir, f"iter{it}-epoch{epoch}", "train")
    for b in range(min(2, inp.shape[0])):
        pred_sdf_vis = np.where(
            (np.abs(sdf_p[b]) < cfg.truncation) & occ[b], sdf_p[b], -np.inf)
        visualize.save_predictions(
            out_dir, f"sample{b}", inp[b],
            np.clip(tgt[b], -cfg.truncation, cfg.truncation),
            tgt_colors[b] if tgt_colors is not None else None,
            sems[b] if sems is not None else None,
            pred_sdf_vis,
            color_p[b] if color_p is not None else None,
            sem_p[b] if sem_p is not None else None,
            truncation=cfg.truncation, color_space=cfg.color_space)


class TrainResult(NamedTuple):
    trainer: Trainer
    iteration: int  # the loop's iteration count at the end
    render_cache: Optional[RenderCache]
    timer: PhaseTimer  # the last iterations' host phases (PhaseTimer.history)


def run_training(
    cfg: TrainConfig,
    train_dataset,
    val_dataset=None,
    save_dir: str = "./logs",
    max_epoch: Optional[int] = None,
    start_epoch: int = 0,
    start_iter: int = 0,
    retrain: str = "",
    retrain_disc: str = "",
    log_every: int = 20,
    ckpt_every_iters: int = 10000,
    seed: int = 0,
    vis_at_epoch_end: bool = True,
    device="cuda",
    vgg=None,
    mesh=None,
) -> TrainResult:
    """Train to ``max_epoch`` (default ``cfg.max_epoch``) on ``device`` (the
    GPU unless the caller asks for the CPU).

    The iteration count ``it`` is the loop's own (the JAX package's
    arithmetic): ``start_iter``, or ``epoch0 * (len(train_dataset) //
    batch_size)``, plus one a step taken. It sets the curriculum flags and the
    log rows; ``Trainer.iteration`` counts optimizer steps, which
    ``skip_batch_on_bad_depth`` can skip. Batches are shuffled with
    ``seed + epoch``. ``retrain`` restores the whole training state of a
    checkpoint and starts at its epoch; ``retrain_disc`` takes the
    discriminator, its spectral state and its Adam from another one.

    Per step the metrics come back to the host in one transfer. At each epoch
    end: a visual dump of the last batch (a failure is printed and training
    goes on), validation into ``log_val.csv`` and, every ``cfg.save_epoch``
    epochs and at the last, ``model-epoch{epoch}.pt`` stored with ``epoch +
    1``; every ``ckpt_every_iters`` iterations ``model-iter{it}-epoch{epoch}.pt``.
    SIGTERM / SIGINT write ``model-preempt-iter{it}.pt`` at the next step
    boundary and return; the previous handlers are restored. ``vgg`` is the
    style / content extractor (``models/vgg.py::load_vgg_for_style``), which
    the steps need once ``StepFlags.for_iter`` schedules style or content.
    ``mesh`` trains data-parallel over its ranks (the module docstring);
    ``cfg.batch_size`` is then the global batch, which the world size must
    divide."""
    n_ranks = mesh.size if mesh is not None else 1
    if cfg.batch_size % n_ranks:
        raise ValueError(f"batch_size {cfg.batch_size} does not split over {n_ranks} ranks")
    local_bs = cfg.batch_size // n_ranks
    primary = multihost.is_primary()
    os.makedirs(save_dir, exist_ok=True)
    trainer = Trainer(cfg, device, seed=seed, vgg=vgg, mesh=mesh)
    epoch0 = start_epoch
    if retrain:
        _, epoch0 = state_lib.load_any_checkpoint(retrain, trainer)
        epoch0 = max(epoch0, start_epoch)
        print(f"loaded checkpoint {retrain} (epoch {epoch0})")
    if retrain_disc and trainer.discriminator is not None:
        # the discriminator from a separate checkpoint (reference train.py:43, :171-178)
        state_lib.load_discriminator(retrain_disc, trainer)
        print(f"loaded disc checkpoint {retrain_disc}")
    pmesh.replicate_state(trainer, mesh)

    def batches(dataset, epoch_seed, shuffle):
        if n_ranks == 1:
            return batch_iterator(dataset, cfg.batch_size, shuffle=shuffle, seed=epoch_seed)
        return batch_iterator(dataset, local_bs, shuffle=False, indices=multihost.local_indices(
            len(dataset), cfg.batch_size, seed=epoch_seed, epoch=0))

    log = TrainLog(save_dir, has_val=val_dataset is not None) if primary else None
    acc = MetricsAccumulator()
    timer = PhaseTimer(report_every=100)
    render_cache = RenderCache(trainer, cfg.cache_renders) if cfg.cache_renders > 0 else None

    def checkpoint(name, stored_epoch):
        state_lib.save_checkpoint(os.path.join(save_dir, name), trainer, stored_epoch)

    # preemption-safe checkpointing (SURVEY.md §5): SIGTERM / SIGINT request a
    # checkpoint at the next step boundary before returning
    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        print(f"signal {signum}: checkpointing at next step boundary")
        stop_requested["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_stop)
        except ValueError:  # not in the main thread
            pass

    def finish():
        if log is not None:
            log.close()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        return TrainResult(trainer, it, render_cache, timer)

    it = start_iter if start_iter > 0 else epoch0 * max(1, len(train_dataset) // cfg.batch_size)
    max_epoch = max_epoch if max_epoch is not None else cfg.max_epoch
    start = time.time()
    last_batch = last_flags = None
    for epoch in range(epoch0, max_epoch):
        for batch in batches(train_dataset, seed + epoch, shuffle=True):
            with timer.phase("setup"):
                names, frame_ids = batch.get("name"), batch.get("frame_ids")
                # every rank must skip alike, or the next collective waits forever
                have_frames = pmesh.all_true(_has_frames(batch), mesh)
                flags = StepFlags.for_iter(it, cfg, have_frames=have_frames)
                skip = flags.use_2d and not have_frames  # reference skip (train.py:428-432)
                if not skip:
                    batch = trainer._to_device(_prepare_batch(batch, cfg, it))
            if skip:
                continue
            precomp = None
            if render_cache is not None and flags.use_2d and names is not None:
                with timer.phase("cache"):
                    precomp = render_cache.lookup(batch, names, frame_ids)
            with timer.phase("step"):
                row = _to_host(trainer.step(batch, flags, precomp=precomp))
            last_batch, last_flags = batch, flags
            it += 1
            with timer.phase("log"):
                acc.add(row)
                if it % log_every == 0 and log is not None:
                    log.log_train(epoch, it, acc.means(), time.time() - start)
                if ckpt_every_iters and it % ckpt_every_iters == 0:
                    checkpoint(f"model-iter{it}-epoch{epoch}.pt", epoch)
            timer.step()
            # a signal usually reaches one rank: any rank stopping stops all
            stop_requested["flag"] = not pmesh.all_true(not stop_requested["flag"], mesh)
            if stop_requested["flag"]:
                checkpoint(f"model-preempt-iter{it}.pt", epoch)
                print(f"preemption checkpoint written at iter {it}; exiting")
                return finish()

        # end of epoch: visual dumps of the last train batch (train.py:771, 789-849),
        # the primary's rows (an eval-mode forward runs no collective)
        if vis_at_epoch_end and last_batch is not None and primary:
            try:
                _dump_visuals(trainer, cfg, last_batch, it, epoch, save_dir, last_flags)
            except Exception as e:  # the dump must never stop training
                print(f"visual dump failed: {e}")

        # end of epoch: validation and checkpoint (train.py:1294-1320)
        if val_dataset is not None:
            val_acc = MetricsAccumulator()
            for batch in batches(val_dataset, 0, shuffle=False):
                have_frames = pmesh.all_true(_has_frames(batch), mesh)
                flags = StepFlags.for_iter(it, cfg, have_frames=have_frames, train=False)
                if flags.use_2d and not have_frames:
                    continue
                val_acc.add(_to_host(trainer.step(_prepare_batch(batch, cfg, it), flags)))
            if log is not None:
                log.log_val(epoch, it, acc.means(), val_acc.means(), time.time() - start)
        acc.reset()
        if (epoch + 1) % cfg.save_epoch == 0 or epoch + 1 == max_epoch:
            checkpoint(f"model-epoch{epoch}.pt", epoch + 1)
    return finish()

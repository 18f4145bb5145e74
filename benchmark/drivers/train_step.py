"""Traffic driver of the training cells: one trainer of the port taking full
training steps back to back (a closed loop), each on the next batch of a pool
made at set-up from the seed, with the upload and the one read of the step's
metrics that ``training/loop.py::run_training`` does around
``Trainer.step``.

Set-up builds the port's ``Trainer`` from the configuration, loads the trained
weights the benchmark read from its own file, and drives it through its first
three steps on pool batches 0-2 (rows that all differ) by the window's own
call: they build and warm every kernel and shape, and they are what the
reference follows after the window (``check``). The window then steps from
pool batch 3 on, cycling.

The comparison (``compare``) covers both networks. Of each of the three
steps: the loss, and the discriminator's loss. Per parameter leaf of the
generator, and apart of the discriminator: the norm of the first gradient as
its optimizer got it (Adam's first moment after one step over ``1 - beta1``),
and the norm of the change after three steps, for the leaves whose reference
gradient is at least a thousandth of the median leaf's. Per layer of the
spectral state (each conv's ``u`` and ``sigma``): the norm of its change after
three steps. A leaf's number is the gap between the two norms over the larger
of the reference's norm and the median leaf's; the worst leaf is compared.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from gen.chunks import make_chunk_batch
from lib.trace import Spans

BETA1 = 0.9
FIRST_STEPS = 3


def load_weights(path: str) -> Dict:
    """The trained checkpoint's generator, discriminator and spectral state
    (CPU tensors), read by the benchmark for both sides."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    return dict(gen=ck["state_dict"], disc=ck["disc_state_dict"], sn=ck["sn_state"])


def make_pool(cfg: Dict, traffic: Dict, seed: int, device, count: int = 0):
    """The pool's batches (the first ``count`` of them if given), each from
    its own seed, so that no two rows of a run are alike."""
    t = cfg["train"]
    n = traffic["pool_batches"]
    image = (t["style_width"], t["style_height"])
    return [make_chunk_batch(traffic["batch"], t["input_dim"], image, seed=seed * n + i,
                             voxelsize=t["voxelsize"], truncation=t["truncation"], device=device)
            for i in range(count or n)]


def _snapshot(module) -> Dict[str, torch.Tensor]:
    return {k: p.detach().float().clone() for k, p in module.named_parameters()}


def _sn_snapshot(sn_state) -> Dict[str, torch.Tensor]:
    return {f"{layer}.{k}": t.detach().float().clone()
            for layer, d in sn_state.items() for k, t in d.items()}


def _first_moments(module, optimizer) -> Dict[str, torch.Tensor]:
    """The first gradient as Adam got it, from its state after one step (zero
    for a parameter the optimizer has not stepped)."""
    out = {}
    for k, p in module.named_parameters():
        m = optimizer.state.get(p, {}).get("exp_avg")
        out[k] = torch.zeros_like(p) if m is None else m.detach().clone() / (1.0 - BETA1)
    return out


class Program:
    """The port's trainer and the calls the window makes into it."""

    def __init__(self, cfg: Dict, weights: Dict, seed: int, device):
        from spsg_tpu_torch.training import StepFlags, TrainConfig
        from spsg_tpu_torch.training.step import Trainer

        t = dict(cfg["train"], input_dim=tuple(cfg["train"]["input_dim"]))
        self.tcfg = TrainConfig(**t)
        self.device = torch.device(device)
        self.trainer = Trainer(self.tcfg, device=device, seed=seed % 2 ** 31)
        self.trainer.generator.load_state_dict(weights["gen"])
        self.trainer.discriminator.load_state_dict(weights["disc"])
        self.trainer.sn_state = {k: {n: v.to(self.device).clone() for n, v in d.items()}
                                 for k, d in weights["sn"].items()}
        self.iteration = cfg["iteration"]
        self.flags = StepFlags.for_iter(self.iteration, self.tcfg)
        w = 1.0 if self.iteration <= self.tcfg.num_iters_geo_only else self.tcfg.weight_occ_loss
        self.weight_occ = np.asarray(w, np.float32)

    def step(self, host_batch: Dict[str, np.ndarray], spans: Spans):
        """One iteration as run_training makes it: the upload, the step, the
        metrics read back in one transfer. Returns the metrics."""
        dev = self.device
        with spans("upload"):
            batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                     for k, v in host_batch.items()}
            batch["weight_occ"] = torch.as_tensor(self.weight_occ).to(dev, non_blocking=True)
        with spans("Trainer.step"):
            m = self.trainer.step(batch, self.flags)
        with spans("metrics read"):
            keys = list(m)
            vals = torch.stack([m[k].float() for k in keys]).cpu().tolist()
        return dict(zip(keys, vals))


def first_steps(pool, nets, step_fn) -> Dict:
    """Three steps on pool batches 0-2; returns what ``compare`` reads.
    ``nets`` is the trainer or the reference: its ``generator``,
    ``optimizer``, ``discriminator``, ``disc_optimizer`` and ``sn_state``."""
    snap = dict(p0=_snapshot(nets.generator), d0=_snapshot(nets.discriminator),
                s0=_sn_snapshot(nets.sn_state), losses=[], disc_losses=[])
    for i in range(FIRST_STEPS):
        m = step_fn(pool[i])
        snap["losses"].append(m["loss"])
        snap["disc_losses"].append(m["loss_disc"])
        if i == 0:
            snap["g1"] = _first_moments(nets.generator, nets.optimizer)
            snap["dg1"] = _first_moments(nets.discriminator, nets.disc_optimizer)
    snap.update(p3=_snapshot(nets.generator), d3=_snapshot(nets.discriminator),
                s3=_sn_snapshot(nets.sn_state))
    return snap


def program_snapshot(prog: Program, pool) -> Dict:
    """The program's first three steps, by the window's own call."""
    spans = Spans()
    return first_steps(pool, prog.trainer, lambda b: prog.step(b, spans))


def setup(ctx) -> Dict:
    cfg, traffic, seed, device = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    t0 = time.perf_counter()
    weights = load_weights(ctx["weights_path"])
    pool = make_pool(cfg, traffic, seed, device)
    t1 = time.perf_counter()
    import spsg_tpu_torch.training.step  # noqa: F401  (timed apart from the trainer)
    t2 = time.perf_counter()
    prog = Program(cfg, weights, seed, device)
    t3 = time.perf_counter()
    snap = program_snapshot(prog, pool)
    if device != "cpu":
        torch.cuda.synchronize()
    phases = dict(inputs=t1 - t0, port_import=t2 - t1, trainer=t3 - t2,
                  first_steps=time.perf_counter() - t3)
    return dict(cfg=cfg, traffic=traffic, seed=seed, device=device, weights=weights, pool=pool,
                prog=prog, snap=snap, phases=phases)


def window(state: Dict, seconds: float) -> Dict:
    prog, pool = state["prog"], state["pool"]
    spans = Spans()
    steps, failed = 0, 0
    i = FIRST_STEPS
    t0 = time.perf_counter()
    with spans("window"):
        while time.perf_counter() - t0 < seconds:
            m = prog.step(pool[i % len(pool)], spans)
            if not all(np.isfinite(v) for v in m.values()):
                failed += 1
            steps += 1
            i += 1
    window_s = time.perf_counter() - t0
    return dict(items=steps, failed=failed, window_s=window_s, spans=spans.items,
                chunks=steps * state["traffic"]["batch"])


def end_to_end(state: Dict, rec: Dict) -> Dict[str, float]:
    return {"train_chunks_per_s": rec["chunks"] / rec["window_s"]}


def window_work(state: Dict, rec: Dict, peaks: Dict) -> Dict:
    from work.spsg import scale, train_step

    return scale(train_step(state["cfg"]["train"], state["traffic"]["batch"], peaks), rec["items"])


def release(state: Dict) -> None:
    """Free the program's state before the reference runs."""
    state.pop("prog", None)


def reference_snapshot(cfg: Dict, weights: Dict, pool, device, tf32: bool = False,
                       fault: str = "") -> Dict:
    """The reference's three steps on pool batches 0-2. ``tf32`` computes it
    in TF32 (the control); ``fault`` plants one of the faults a training step
    can have: ``unchanged`` (no update of the generator), ``disc_unchanged``
    (no update of the discriminator's parameters and spectral state),
    ``half_batch`` (the first half of every batch, the mean over it)."""
    from reference.step import Reference

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        ref = Reference(cfg["train"], weights["gen"], weights["disc"], weights["sn"], device)
        t = cfg["train"]
        it = cfg["iteration"]
        w = np.float32(1.0 if it <= t["num_iters_geo_only"] else t["weight_occ_loss"])
        frozen = dict(unchanged=ref.generator, disc_unchanged=ref.discriminator).get(fault)

        def step(b):
            batch = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
            if fault == "half_batch":
                n = max(1, batch["input"].shape[0] // 2)
                batch = {k: v[:n] for k, v in batch.items()}
            batch["weight_occ"] = torch.as_tensor(w).to(device)
            if frozen is None:
                return ref.step(batch)
            saved = {k: p.detach().clone() for k, p in frozen.named_parameters()}
            sn = ref.sn_state
            m = ref.step(batch)
            with torch.no_grad():
                for k, p in frozen.named_parameters():
                    p.copy_(saved[k])
            if fault == "disc_unchanged":
                ref.sn_state = sn
            return m

        return first_steps(pool, ref, step)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    if not keys:
        return 0.0
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def _change(snap: Dict, a: str, b: str) -> Dict[str, float]:
    return _norms({k: snap[b][k] - snap[a][k] for k in snap[a]})


def _net_gaps(prog: Dict, ref: Dict, grad: str, p0: str, p3: str) -> tuple:
    """(first gradient gap, change gap) of one network, worst leaf each."""
    g_p, g_r = _norms(prog[grad]), _norms(ref[grad])
    med_g = float(np.median(list(g_r.values())))
    moved = [k for k in g_r if g_r[k] >= 1e-3 * med_g and g_r[k] > 0]
    return (_worst_leaf(g_p, g_r, g_r),
            _worst_leaf(_change(prog, p0, p3), _change(ref, p0, p3), moved))


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers held to the cell's limits (the module docstring)."""
    out = {}
    for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"])):
        out[f"loss_gap.step{i + 1}"] = abs(a - b) / max(abs(b), 1e-30)
    for i, (a, b) in enumerate(zip(prog["disc_losses"], ref["disc_losses"])):
        out[f"loss_disc_gap.step{i + 1}"] = abs(a - b) / max(abs(b), 1e-30)
    out["grad1_gap"], out["change3_gap"] = _net_gaps(prog, ref, "g1", "p0", "p3")
    out["disc_grad1_gap"], out["disc_change3_gap"] = _net_gaps(prog, ref, "dg1", "d0", "d3")
    s_r = _change(ref, "s0", "s3")
    out["sn_change3_gap"] = _worst_leaf(_change(prog, "s0", "s3"), s_r, s_r)
    return out


def check(state: Dict, rec: Dict) -> Dict[str, float]:
    ref = reference_snapshot(state["cfg"], state["weights"], state["pool"], state["device"])
    return compare(state["snap"], ref)

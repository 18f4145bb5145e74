"""Traffic driver of the chunked-serving cells: one client calling the port's
``run_chunked_inference`` on rooms back to back (a closed loop), as the
serving CLI works through its scene list with ``--compact_feed``: the raw
scene (float SDF, uint8 colours) goes in, stitched occupancy, SDF, colours and
labels with the IoU sums come out, and ``summarize_iou`` is taken of them.

The pool holds ``pool_per_size`` rooms of each size the traffic lists, made at
set-up on the device from the seed (``gen/scenes.py::served_room``) and handed
over as host arrays. The seed draws each room's content and the order the
window visits the pool in. Set-up warms the path on one room of each size and
once more on the largest.

The comparison (``compare``): a sample of the rooms the window completed,
drawn from the seed, with the largest room in it, each run again by the
reference (``reference/chunked.py``) from the same raw arrays; the worst over
the sample of: the SDF's largest gap on the voxels whose windows agree, the
share of voxels whose occupancy or window count differ, the shares of the
agreeing voxels' colour channels (0-255) and labels that differ, and the
largest gap of the geometry or the mean class IoU.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from gen.scenes import served_room
from lib.trace import Spans


def pool_extents(traffic: Dict) -> List[tuple]:
    """The (Z, Y, X) of each room of the pool."""
    return [tuple(d) for d in traffic["rooms"] for _ in range(traffic["pool_per_size"])]


def make_room(traffic: Dict, seed: int, i: int, device) -> Dict[str, np.ndarray]:
    """Room ``i`` of the pool of ``seed``."""
    ext = pool_extents(traffic)
    return served_room(ext[i], seed * len(ext) + i, device, traffic)


def make_pool(traffic: Dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    return [make_room(traffic, seed, i, device) for i in range(len(pool_extents(traffic)))]


def load_generator_state(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)["state_dict"]


class Program:
    """The port's generator, built as the serving CLI builds it."""

    def __init__(self, cfg: Dict, state_dict, device):
        from spsg_tpu_torch.inference import chunked
        from spsg_tpu_torch.training import TrainConfig
        from spsg_tpu_torch.training.state import init_generator

        s = cfg["serve"]
        self.s = s
        self.chunked = chunked
        tcfg = TrainConfig(input_dim=tuple(s["chunk_dims"]), truncation=s["truncation"],
                           nf_gen=s["nf_gen"], color_space=s["color_space"],
                           weight_disc_loss=0.0)
        self.generator = init_generator(tcfg, torch.Generator().manual_seed(0), device)
        self.generator.load_state_dict(state_dict)
        self.device = device

    def serve(self, room: Dict[str, np.ndarray]):
        s = self.s
        out = self.chunked.run_chunked_inference(
            self.generator, None, None, room["target_sdf"], room["known"], room["semantics"],
            compact_scene=dict(sdf=room["sdf_input"], colors=room["input_colors"],
                               color_space=s["color_space"]),
            truncation=s["truncation"], chunk_dims=tuple(s["chunk_dims"]), stride=s["stride"],
            pad=s["pad"], max_height=s["max_height"], window_batch=s["window_batch"],
            pred_color=s["pred_color"], pred_semantic=s["pred_semantic"], device=self.device)
        summary = self.chunked.summarize_iou(out.geo_intersection, out.geo_union,
                                             out.class_intersection, out.class_union,
                                             out.class_weight)
        return out, summary


def _largest(traffic) -> int:
    ext = pool_extents(traffic)
    return max(range(len(ext)), key=lambda i: ext[i][1] * ext[i][2])


def visit_order(traffic: Dict, seed: int) -> List[int]:
    """The order the window visits the pool in, drawn from the seed."""
    rng = np.random.default_rng(seed)
    return [int(i) for i in rng.permutation(len(pool_extents(traffic)))]


def check_rooms(traffic: Dict, seed: int) -> List[int]:
    """The rooms compared: the largest and the first others the window visits."""
    big = _largest(traffic)
    others = [i for i in visit_order(traffic, seed) if i != big]
    return [big] + others[:traffic["check_rooms"] - 1]


def setup(ctx) -> Dict:
    cfg, traffic, seed, device = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    t0 = time.perf_counter()
    state_dict = load_generator_state(ctx["weights_path"])
    pool = make_pool(traffic, seed, device)
    t1 = time.perf_counter()
    prog = Program(cfg, state_dict, device)
    t2 = time.perf_counter()
    ext = pool_extents(traffic)
    for i in sorted({ext.index(d) for d in ext}) + [_largest(traffic)]:
        prog.serve(pool[i])
    phases = dict(inputs=t1 - t0, program=t2 - t1, warm_up=time.perf_counter() - t2)
    return dict(cfg=cfg, traffic=traffic, seed=seed, device=device, state_dict=state_dict,
                pool=pool, prog=prog, order=visit_order(traffic, seed),
                check_ids=check_rooms(traffic, seed), phases=phases)


def window(state: Dict, seconds: float) -> Dict:
    prog, pool, order = state["prog"], state["pool"], state["order"]
    latencies, voxels, done = [], 0, []
    kept: Dict[int, tuple] = {}
    spans = Spans()
    failed = 0
    k = 0
    t0 = time.perf_counter()
    with spans("window"):
        while time.perf_counter() - t0 < seconds:
            i = order[k % len(order)]
            room = pool[i]
            ta = time.perf_counter()
            with spans("run_chunked_inference"):
                out, summary = prog.serve(room)
            tb = time.perf_counter()
            with spans("between scenes"):
                latencies.append(tb - ta)
                voxels += int(np.prod(room["sdf_input"].shape))
                done.append(i)
                if not np.isfinite(summary["geo_iou"]):
                    failed += 1
                if i in state["check_ids"] and i not in kept:
                    kept[i] = (out, summary)
                k += 1
    window_s = time.perf_counter() - t0
    return dict(items=len(done), failed=failed, window_s=window_s, latencies=latencies,
                voxels=voxels, done=done, kept=kept, spans=spans.items,
                windows=sum(_n_windows(state, i) for i in done))


def _n_windows(state: Dict, i: int) -> int:
    s = state["cfg"]["serve"]
    _, Y, X = state["pool"][i]["sdf_input"].shape
    return len(range(0, Y, s["stride"])) * len(range(0, X, s["stride"]))


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the order statistics (numpy's
    default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(state: Dict, rec: Dict) -> Dict[str, float]:
    return {"serve_voxels_per_s": rec["voxels"] / rec["window_s"],
            "serve_scene_s_p90": percentile(rec["latencies"], 90)}


def window_work(state: Dict, rec: Dict, peaks: Dict) -> Dict:
    from work.spsg import serve_forward

    return serve_forward(state["cfg"]["serve"], rec["windows"], peaks)


def release(state: Dict) -> None:
    state.pop("prog", None)


def reference_outputs(cfg: Dict, state_dict, room, device, tf32: bool = False, fault: str = ""):
    """The reference's stitched outputs of one room. ``tf32`` computes it in
    TF32 (the control); ``fault`` plants ``window_altered`` (one window's SDF
    negated where it is produced) or ``half_batch`` (half of every window
    batch left out)."""
    from reference import chunked as ref_chunked
    from reference.generator import Generator

    s = cfg["serve"]
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        gen = Generator(s["nf_gen"], s["truncation"]).to(device)
        gen.load_state_dict(state_dict)
        forward = gen.forward
        calls = [0]

        def faulty(cb, mb, pred_color=True, pred_semantic=True):
            occ, sdf, col, sem = forward(cb, mb, pred_color, pred_semantic)
            if fault == "window_altered" and calls[0] == 0:
                sdf = sdf.clone()
                sdf[0] = -sdf[0]
            if fault == "half_batch":
                n = cb.shape[0]
                keep = max(1, n // 2)
                occ = torch.cat([occ[:keep], torch.full_like(occ[keep:], -10.0)])
            calls[0] += 1
            return occ, sdf, col, sem

        if fault:
            gen.forward = faulty
        out = ref_chunked.run_chunked(
            gen, room["sdf_input"], room["input_colors"], room["target_sdf"], room["known"],
            room["semantics"], truncation=s["truncation"], chunk_dims=tuple(s["chunk_dims"]),
            stride=s["stride"], pad=s["pad"], max_height=s["max_height"],
            window_batch=s["window_batch"], color_space=s["color_space"], device=device)
        summary = ref_chunked.summarize_iou(out.geo_intersection, out.geo_union,
                                            out.class_intersection, out.class_union,
                                            out.class_weight)
        return out, summary
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def compare_room(prog, ref) -> Dict[str, float]:
    """One room's numbers. Voxels whose windows agree (the same overlap count
    on both sides, a predicted surface on both) are compared by value; a
    voxel where the occupancy or the count differs (a window whose
    occupancy or surface test came out the other way) counts as a mismatch."""
    (po, ps), (ro, rs) = prog, ref
    same = (po.counts == ro.counts) & (ro.counts > 0) & np.isfinite(po.sdf) & np.isfinite(ro.sdf)
    n = po.sdf.size
    sdf_gap = float(np.abs(po.sdf[same] - ro.sdf[same]).max()) if same.any() else 0.0
    mismatch = float(((po.occ != ro.occ) | (po.counts != ro.counts)).sum()) / n
    m = max(int(same.sum()), 1)
    color = float((po.colors[same] != ro.colors[same]).sum()) / (3 * m)
    label = float((po.sem_labels[same] != ro.sem_labels[same]).sum()) / m
    iou = max(abs(ps["geo_iou"] - rs["geo_iou"]), abs(ps["mean_iou"] - rs["mean_iou"]))
    return {"sdf_gap": sdf_gap, "voxel_mismatch": mismatch, "color_mismatch": color,
            "label_mismatch": label, "iou_gap": iou}


def compare(pairs) -> Dict[str, float]:
    """The worst of each number over the rooms compared."""
    out: Dict[str, float] = {}
    for prog, ref in pairs:
        for k, v in compare_room(prog, ref).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def check(state: Dict, rec: Dict) -> Dict[str, float]:
    pairs = []
    for i in state["check_ids"]:
        if i in rec["kept"]:
            ref = reference_outputs(state["cfg"], state["state_dict"], state["pool"][i],
                                    state["device"])
            pairs.append((rec["kept"][i], ref))
    if not pairs:
        raise RuntimeError("serve_chunked: no room of the sample was completed in the window")
    return compare(pairs)

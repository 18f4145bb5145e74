"""The traced run's device trace: ``torch.profiler`` (CUPTI) over the whole
measured window, reduced to what the per-layer readers need.

The profiler records the device's activity only (CUPTI), so that the host
path runs at its untraced speed. Host spans are the benchmark's own
(:class:`Spans`, around its calls into the port), stamped with
``time.time_ns()``, the Unix-nanosecond clock the profiler's events carry
too. The reduction keeps,
for the window: every device operation's name and interval, the union of those
intervals (``busy_s``), device seconds by layer (``layers/*.json``), the idle
gaps labelled by the innermost benchmark span the host was in, and the top
operations. Nothing here imports the port."""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional, Tuple


class Spans:
    """The benchmark's host spans: ``with spans("name"): ...`` records
    (name, start_ns, end_ns) on the Unix-nanosecond clock."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    @staticmethod
    def seconds_of(items) -> Dict[str, List[float]]:
        """Each span name's durations, seconds."""
        out: Dict[str, List[float]] = {}
        for name, a, b in items:
            out.setdefault(name, []).append((b - a) * 1e-9)
        return out


class Tracer:
    """``torch.profiler`` over the measured window. ``start()`` before the
    window (the profiler's own start-up is set-up), ``stop()`` after it. A CPU
    run (the tests') traces the host, which has no device operations."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        act = ProfilerActivity.CUDA if self.device == "cuda" else ProfilerActivity.CPU
        self.prof = profile(activities=[act])
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)

    def device_ops(self) -> List[Tuple[str, int, int]]:
        """Every operation the device ran: kernels, copies, sets (name,
        start_ns, end_ns); annotations are not operations."""
        import torch

        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation()]


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label(spans, starts, t: int) -> str:
    """The benchmark span around time t: the spans inside the window do not
    nest, so it is the last one to start before t, if it has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][1] <= t < spans[i][2]:
        return spans[i][0]
    return "between spans"


def reduce(dev_ops, spans, classify, window: Tuple[int, int]) -> Dict:
    """The window's summary. ``classify(name) -> layer`` (``lib/layers.py``);
    ``window`` (start_ns, end_ns) is the measured window's span."""
    w0, w1 = window
    ops = [(n, max(a, w0), min(b, w1)) for n, a, b in dev_ops if b > w0 and a < w1]
    busy = union([(a, b) for _, a, b in ops])
    busy_ns = sum(b - a for a, b in busy)
    by_layer: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    cache: Dict[str, str] = {}
    for n, a, b in ops:
        layer = cache.get(n)
        if layer is None:
            layer = cache[n] = classify(n)
        by_layer[layer] = by_layer.get(layer, 0.0) + (b - a) * 1e-9
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    # idle gaps between busy stretches (and at the window's ends), by host span
    inner = sorted((s for s in spans if s[2] > w0 and s[1] < w1 and s[0] != "window"),
                   key=lambda s: s[1])
    starts = [s[1] for s in inner]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            label = _label(inner, starts, (a + b) // 2)
            gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, by_layer=by_layer,
                device_ops=[[n[:160], s] for n, s in top_ops],
                idle_gaps=[[n, s] for n, s in top_gaps])


def window_of(spans) -> Optional[Tuple[int, int]]:
    for name, a, b in spans:
        if name == "window":
            return a, b
    return None

"""Phase timers (reference hand-rolled wall-clock timers, train.py:850-863)
plus a torch.profiler hook (PyTorch counterpart of
``spsg_tpu/utils/timing.py``)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional


class PhaseTimer:
    """Accumulates per-phase wall-clock durations and prints averages every
    ``report_every`` steps (matching the reference's every-100-iters report).

    The phases time the host only: entering or leaving one reads nothing back
    from the device. The last ``HISTORY`` steps' phases are also kept, one
    ``{phase: seconds}`` dict a step, in :attr:`history` (what a caller that
    measures the loop reads, e.g. ``chip_smoke.py``)."""

    HISTORY = 1000

    def __init__(self, report_every: int = 100):
        self.report_every = report_every
        self._acc: Dict[str, List[float]] = defaultdict(list)
        self._count = 0
        self.history: Deque[Dict[str, float]] = deque(maxlen=self.HISTORY)
        self._current: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._acc[name].append(dt)
        self._current[name] = self._current.get(name, 0.0) + dt

    def step(self, log_fn=print) -> None:
        self.history.append(self._current)
        self._current = {}
        self._count += 1
        if self._count % self.report_every == 0:
            parts = [f"{k}: {sum(v) / max(len(v), 1):.4f}s" for k, v in self._acc.items()]
            log_fn("Average timings: " + " | ".join(parts))
            self._acc.clear()


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """Optional torch.profiler trace around a region, written as a Chrome
    trace to ``<log_dir>/trace.json`` (the JAX package's ``jax_trace``). The
    device is traced when there is one."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

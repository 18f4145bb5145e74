"""Phase timers (reference hand-rolled wall-clock timers, train.py:850-863),
the program's span and counter recorder, and a torch.profiler hook (PyTorch
counterpart of ``spsg_tpu/utils/timing.py``).

The recorder is one object, :data:`RECORDER`, whose methods the module also
exports: ``span(name, stream=False)``, ``count(name, n=1)``,
``enable(stream_markers=False)``, ``disable()`` and ``drain()``. It records
between ``enable()`` and ``disable()``, and while a ``torch.profiler``
session records (so a profiled region, such as a benchmark's traced window,
holds the program's spans without a call into this module). Otherwise it is
off; off, ``span()`` returns one shared no-op context manager (no allocation,
no clock read) and ``count()`` returns after a flag check and the profiler's
flag. The program names its spans ``train.*`` (``training/step.py``, and
:class:`PhaseTimer`'s phases as ``train.loop.*``) and ``serve.*``
(``inference/chunked.py``).

On, a span records its name, its request id, its parent span and its start
and end from ``time.time_ns()``: the Unix-nanosecond clock that
``torch.profiler``'s events carry, so spans and a device trace line up. A
span opened inside another takes the other's request id; a span opened
outside any other starts a request, numbered from one count of such spans
since :meth:`Recorder.enable` or the profiler session's start (in a loop of
bare ``Trainer.step`` calls, the step's count; of ``run_chunked_inference``
calls, the call's), so no two trees share an id. With stream markers on, a
span opened with ``stream=True`` also records a CUDA event on the current
stream at its start and at its end, from a pool allocated by ``enable()``;
``drain()`` synchronises once and gives each such span its **stream ms**: the
time between the device reaching the two markers, which is the device work
the span enqueued plus the device's idle time inside it (the host enqueuing
slower than the device runs, or a read that empties the queue). Markers are
on with ``enable(stream_markers=True)`` where CUDA is available, and in a
profiler session where the process has already initialised CUDA; without
them, stream ms is None. Records are kept in memory and handed over only by
``drain()``, which is called while no span is open; a profiler session's
first span or count starts the record afresh, dropping what an earlier one
left undrained."""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional

import torch
from torch._C._autograd import _profiler_enabled

_OFF = contextlib.nullcontext()


class _Span:
    """One span: the context manager ``Recorder.span`` returns, and its record."""

    __slots__ = ("rec", "name", "stream", "request", "parent", "start_ns", "end_ns", "events")

    def __init__(self, rec: "Recorder", name: str, stream: bool):
        self.rec, self.name, self.stream = rec, name, stream
        self.end_ns = self.events = None

    def __enter__(self):
        rec = self.rec
        if rec._stack:
            self.parent = rec._stack[-1]
            self.request = rec._records[self.parent].request
        else:
            self.parent = None
            self.request = rec._requests
            rec._requests += 1
        self.start_ns = time.time_ns()
        if self.stream:
            self.events = (rec._event(), rec._event())
            self.events[0].record()
        rec._stack.append(len(rec._records))
        rec._records.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.time_ns()
        self.rec._stack.pop()
        return False


class Recorder:
    """Spans and counters of the program (the module docstring)."""

    POOL = 4096  # CUDA events made by enable(); more are made if a run needs them

    def __init__(self):
        self.on = False
        self._session = False  # recording because a profiler session records
        self._markers = False
        self._records: List[_Span] = []
        self._counts: Dict[str, int] = {}
        self._stack: List[int] = []
        self._requests = 0
        self._pool: list = []

    def enable(self, stream_markers: bool = False) -> None:
        """Start recording; request numbers start again. ``stream_markers``
        takes effect only where CUDA is available."""
        self._markers = stream_markers and torch.cuda.is_available()
        if self._markers and len(self._pool) < self.POOL:
            # an event's CUDA object is made at its first record: make them here
            fresh = [torch.cuda.Event(enable_timing=True)
                     for _ in range(self.POOL - len(self._pool))]
            for e in fresh:
                e.record()
            torch.cuda.synchronize()
            self._pool.extend(fresh)
        self._requests = 0
        self.on = True

    def disable(self) -> None:
        self.on = False

    def _profiled(self) -> bool:
        """Whether a ``torch.profiler`` session records; its first call in a
        session starts the record afresh (unless a span is still open)."""
        if not _profiler_enabled():
            self._session = False
            return False
        if not self._session:
            self._session = True
            if not self._stack:
                self._records, self._counts = [], {}
                self._markers = torch.cuda.is_initialized()
                self._requests = 0
        return True

    def span(self, name: str, stream: bool = False):
        """A context manager that records the span ``name``; ``stream`` also
        marks the CUDA stream at its ends (with stream markers on)."""
        if not (self.on or self._profiled()):
            return _OFF
        return _Span(self, name, stream and self._markers)

    def count(self, name: str, n: int = 1) -> None:
        if self.on or self._profiled():
            self._counts[name] = self._counts.get(name, 0) + n

    def _event(self):
        if self._pool:
            return self._pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def drain(self) -> Dict:
        """The records since the last drain, cleared here: ``{"spans": [{name,
        request, parent (index in this list or None), start_ns, end_ns,
        stream_ms}], "counts": {name: n}}``. Synchronises the device once if
        a span holds stream markers."""
        records, self._records = self._records, []
        counts, self._counts = self._counts, {}
        if any(r.events is not None for r in records):
            torch.cuda.synchronize()
        spans = []
        for r in records:
            ms = None
            if r.events is not None:
                ms = r.events[0].elapsed_time(r.events[1])
                self._pool.extend(r.events)
            spans.append(dict(name=r.name, request=r.request, parent=r.parent,
                              start_ns=r.start_ns, end_ns=r.end_ns, stream_ms=ms))
        return {"spans": spans, "counts": counts}


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
enable = RECORDER.enable
disable = RECORDER.disable
drain = RECORDER.drain


class PhaseTimer:
    """Accumulates per-phase wall-clock durations and prints averages every
    ``report_every`` steps (matching the reference's every-100-iters report).

    The phases time the host only: entering or leaving one reads nothing back
    from the device. The last ``HISTORY`` steps' phases are also kept, one
    ``{phase: seconds}`` dict a step, in :attr:`history` (what a caller that
    measures the loop reads, e.g. ``chip_smoke.py``). With the recorder on, a
    phase is also its span ``train.loop.<phase>``."""

    HISTORY = 1000
    SPAN_PREFIX = "train.loop."

    def __init__(self, report_every: int = 100):
        self.report_every = report_every
        self._acc: Dict[str, List[float]] = defaultdict(list)
        self._count = 0
        self.history: Deque[Dict[str, float]] = deque(maxlen=self.HISTORY)
        self._current: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with span(self.SPAN_PREFIX + name):
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
    trace to ``<log_dir>/trace.json`` (the JAX package's ``jax_trace``), with
    the recorder on, without stream markers (a long run would hold two CUDA
    events a stream span): its spans and counters go to
    ``<log_dir>/spans.json`` (:meth:`Recorder.drain`'s record, on the trace's
    clock). The device is traced when there is one."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    enable()
    try:
        with profile(activities=acts) as prof:
            yield
    finally:
        disable()
        record = drain()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(record, f)

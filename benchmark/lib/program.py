"""The program's own spans and counters in the traced run, and the arithmetic
of the readers that take their numbers from them (``metrics/<name>.py``).

The port's recorder (``spsg_tpu_torch/utils/timing.py``) records while a
``torch.profiler`` session records, which in the traced run is the measured
window (``lib/trace.py``'s ``Tracer``). The first reader to ask drains it,
after the window, and keeps the record in its context as
``ctx["program"]`` for the others: ``{"spans": [{name, request, parent,
start_ns, end_ns, stream_ms}], "counts": {name: n}}``, on the
Unix-nanosecond clock of the device trace; ``stream_ms`` is the time between
the device reaching the CUDA-event markers at a span's ends (None without
markers: on a CPU run). A port whose ``timing`` module has no recorder (the
port as it was before the recorder, which the traced run also measures with
this benchmark) gives no record, and every reader then returns None."""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def record_of(ctx) -> Optional[Dict]:
    """The program's record of the window, drained once into
    ``ctx["program"]``; None where the port has no recorder."""
    if "program" not in ctx:
        from spsg_tpu_torch.utils import timing

        ctx["program"] = timing.drain() if hasattr(timing, "drain") else None
    return ctx["program"]


def _ms(record: Dict, names: Sequence[str], clock: str) -> Optional[float]:
    """Milliseconds of the spans named ``names``, summed: on the host's clock
    (``clock`` "host") or between the device's markers ("stream"). None
    without such a span, or with a span that has no stream time."""
    spans = [s for s in record["spans"] if s["name"] in names]
    if not spans:
        return None
    if clock == "stream":
        ms = [s["stream_ms"] for s in spans]
        if any(v is None for v in ms):
            return None
    else:
        ms = [(s["end_ns"] - s["start_ns"]) * 1e-6 for s in spans]
    return sum(ms)


def per_count(ctx, names: Sequence[str], counter: str, clock: str) -> Optional[float]:
    """Milliseconds of the spans named ``names`` (:func:`_ms`) over the
    counter ``counter``. None without a record, without such a span, with
    the counter at 0, or with a span that has no stream time."""
    record = record_of(ctx)
    n = record["counts"].get(counter, 0) if record else 0
    ms = _ms(record, names, clock) if n else None
    return None if ms is None else ms / n


def count_per(ctx, counter: str, per: str) -> Optional[float]:
    """The counter ``counter`` over the counter ``per``. None without a
    record or with ``per`` at 0."""
    record = record_of(ctx)
    n = record["counts"].get(per, 0) if record else 0
    return record["counts"].get(counter, 0) / n if n else None


def per_second(ctx, counter: str, names: Sequence[str], clock: str,
               unit: float = 1.0) -> Optional[float]:
    """The counter ``counter``, in ``unit``s, over the seconds of the spans
    named ``names`` (:func:`_ms`'s ``clock``). None without a record, without
    such a span, with the counter at 0, or with a span that has no stream
    time."""
    record = record_of(ctx)
    n = record["counts"].get(counter, 0) if record else 0
    ms = _ms(record, names, clock) if n else None
    return None if not ms else n / unit / (ms * 1e-3)

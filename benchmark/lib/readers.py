"""Shared arithmetic of the per-layer readers (``metrics/<name>.py``). Each
takes the traced run's context (``run.py``): ``trace`` (``lib/trace.py``'s
summary of the window), ``work`` (the window's operations and bounds by
group, ``work/``), ``peaks``, ``items`` (steps or scenes in the window),
``host`` (benchmark spans on the host clock, seconds) and
``memory_peak_bytes``. A reader that finds nothing to read returns None."""

from __future__ import annotations

from typing import Optional, Sequence

from work.spsg import peak_rates


def mfu(ctx) -> Optional[float]:
    tr, work = ctx.get("trace"), ctx.get("work")
    if not tr or not work or tr["window_s"] <= 0:
        return None
    return 100.0 * work["total_flops"] / (tr["window_s"] * peak_rates(ctx["peaks"])[0])


def roofline(ctx, groups: Sequence[str], layer: str) -> Optional[float]:
    """The groups' summed least time over the device time of the layer's
    kernels in the window, in percent."""
    tr, work = ctx.get("trace"), ctx.get("work")
    if not tr or not work or any(g not in work for g in groups):
        return None
    t = tr["by_layer"].get(layer, 0.0)
    if t <= 0.0:
        return None
    return 100.0 * sum(work[g]["bound_s"] for g in groups) / t


def device_ms_per_item(ctx, layer: str) -> Optional[float]:
    tr = ctx.get("trace")
    t = tr["by_layer"].get(layer, 0.0) if tr else 0.0
    if t <= 0.0 or not ctx.get("items"):
        return None
    return 1e3 * t / ctx["items"]


def host_ms(ctx, span: str) -> Optional[float]:
    vals = (ctx.get("host") or {}).get(span)
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)


def idle_share(ctx) -> Optional[float]:
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_gib(ctx) -> Optional[float]:
    b = ctx.get("memory_peak_bytes")
    return None if not b else b / 2.0 ** 30

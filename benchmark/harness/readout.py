"""Helpers the metric files share: sums of spans per request, roofline
shares, percentiles."""

from __future__ import annotations

import numpy as np

from .yardstick import bound


def percentile(view, q: float) -> float | None:
    ms = [r.ms for r in view.requests]
    return float(np.percentile(np.asarray(ms), q)) if ms else None


def per_request(view, target: str, field: str = "host_ms") -> float | None:
    """The mean over the window's completed requests of the summed
    ``field`` (``host_ms`` or ``device_ms``) of ``target``'s calls in each;
    None where ``target`` was not timed, never called, or has no such
    reading (device times on a CPU run)."""
    spans = view.spans.of(target) if view.spans is not None else None
    if not spans or not view.requests:
        return None
    vals = [getattr(s, field) for s in spans]
    if any(v is None for v in vals):
        return None
    return float(sum(vals)) / len(view.requests)


def roofline_pct(view, target: str) -> float | None:
    """100 x the summed least time of ``target``'s calls (from the bytes
    and operations each call's note records) over their summed CUDA-event
    time; None without device times."""
    spans = view.spans.of(target) if view.spans is not None else None
    if not spans or any(s.device_ms is None for s in spans):
        return None
    least = sum(bound(s.notes["bytes"], s.notes["flops"])[0] for s in spans)
    took = sum(s.device_ms for s in spans)
    return 100.0 * least / took if took > 0 else None


def idle_pct(view) -> float | None:
    """100 x (1 - device busy / traced window); None without a trace or
    with no device activity in it."""
    t = view.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

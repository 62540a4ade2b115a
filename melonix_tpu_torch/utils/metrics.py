"""Lightweight metrics — counters, rates, timers.

The reference's only operator feedback is an FPS readout (app.cpp:84) and
ad-hoc LOG lines (SURVEY.md §5).  Here every subsystem feeds a process-wide
registry: the tile server counts tiles and drain batches, the render engines
count planned/rendered seconds, the web shell reads frames-per-second and
tiles-per-second the same way the reference surfaced its FPS.  Thread-safe
(the tile worker and HTTP threads write concurrently).  A copy of
``melonix_tpu/utils/metrics.py``: the two packages share no code.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class Counter:
    """Monotonic counter with a thread-safe ``inc``."""

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class RateMeter:
    """Events/second over a sliding window (the FPS-readout primitive)."""

    def __init__(self, window: float = 5.0):
        self.window = window
        self._events: deque = deque()
        self._lock = threading.Lock()

    def tick(self, n: int = 1, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((now, n))
            self._trim(now)

    def rate(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._trim(now)
            if not self._events:
                return 0.0
            total = sum(n for _, n in self._events)
            span = max(now - self._events[0][0], 1e-9)
            return total / span

    def _trim(self, now: float) -> None:
        while self._events and self._events[0][0] < now - self.window:
            self._events.popleft()


class Timer:
    """Accumulating context-manager timer: total seconds + call count.

    The start time lives in thread-local storage so one registry Timer can
    be entered concurrently from several threads (e.g. two tile workers).
    """

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def __enter__(self):
        self._local.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._local.t0
        with self._lock:
            self.total += dt
            self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


_REGISTRY: dict = {}
_REG_LOCK = threading.Lock()


def registry(name: str, kind=Counter):
    """Get-or-create a named metric (``kind`` = Counter/RateMeter/Timer)."""
    with _REG_LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = kind()
        return m


def snapshot() -> dict:
    """One JSON-friendly dict of every registered metric."""
    with _REG_LOCK:
        items = list(_REGISTRY.items())
    out = {}
    for name, m in items:
        if isinstance(m, Counter):
            out[name] = m.value
        elif isinstance(m, RateMeter):
            out[name] = round(m.rate(), 3)
        elif isinstance(m, Timer):
            out[name] = {"total_s": round(m.total, 6), "count": m.count,
                         "mean_s": round(m.mean, 6)}
    return out

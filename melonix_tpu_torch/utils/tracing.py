"""Profiling, the program's spans and structured logging (counterpart of
``melonix_tpu/utils/tracing.py``).

Replaces the reference's LOG(...) macro (mika314/log, used at app.cpp:144,
740, 950 etc.) with stdlib structured logging, and its nothing-at-all
profiling story with ``torch.profiler`` and a recorder of the program's own
spans:

- :func:`trace` wraps a region and writes a Chrome trace (open it in
  Perfetto or ``chrome://tracing``), with the recorder on inside it and
  the region's records, counts and device times in the file;
- :func:`span` names a region of the program.  With the recorder off (the
  default) it reads one flag and returns a shared context that does
  nothing.  Started (:func:`start`), each span keeps a :class:`Record`:
  its name, its host interval on ``time.perf_counter_ns()``, its parent
  and its request (the outermost span of its thread), the counts it was
  given (``bytes``, ``frames``, ...) and, for a span given a CUDA
  ``device``, the time between a pair of CUDA events recorded on that
  device's current stream at its ends, read by :func:`resolve` (on an idle
  card the first event fires at once, so this takes in the host's time up
  to the span's first launch).  While a
  ``torch.profiler`` session runs, each span also opens a
  ``record_function`` of its name, so the trace's own clock carries it.

Records go into one buffer of :data:`CAPACITY` records, kept from
:func:`start` until the next :func:`start`; past it they are counted by
:func:`dropped` and not kept.  The stack of open spans is per thread (the
tile worker and the web threads run spans too).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import NamedTuple

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"

CAPACITY = 1 << 19  # records kept from one start() to the next


def get_logger(name: str = "melonix") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger("melonix").handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("melonix")
        root.addHandler(h)
        root.setLevel(logging.INFO)
    return logger


# ----------------------------------------------------------------------
# The recorder
# ----------------------------------------------------------------------


class Record(NamedTuple):
    """One span.  ``parent`` and ``root`` are indices into :func:`records`
    (``parent`` None for a request's outermost span, whose ``root`` is its
    own index); ``t1_ns`` is None while the span is open; ``counts`` is a
    dict or None; ``device_ms`` is None until :func:`resolve` reads the
    span's CUDA events, and stays None for a span without them.  A tuple:
    cheaper to make, and to collect, than an object a span."""

    name: str
    t0_ns: int
    t1_ns: int | None
    parent: int | None
    root: int | None
    counts: dict | None
    device_ms: float | None

    @property
    def host_ms(self) -> float:
        return 1e-6 * (self.t1_ns - self.t0_ns)


_on = False  # the one flag a span reads when the recorder is off
_lock = threading.Lock()
_records: list[Record] = []
_pending: list[tuple] = []  # (index, device, start event, end event)
_dropped = 0
_local = threading.local()  # .stack: the thread's open (index, root)s
_torch = None  # torch, imported by start()
_now = time.perf_counter_ns
_record = tuple.__new__


class _Off:
    """The span of a recorder that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    """An open span: keeps its record's place in the buffer until it
    closes, then writes the record there."""

    __slots__ = ("name", "counts", "device", "buffer", "index", "parent",
                 "root", "t0_ns", "stack", "events", "region")

    def __init__(self, name: str, device, counts: dict | None):
        self.name, self.device, self.counts = name, device, counts
        self.events = self.region = None

    def __enter__(self):
        global _dropped
        torch = _torch
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent, root = stack[-1] if stack else (None, None)
        self.t0_ns = t0 = _now()
        # record_function's region, through the entry it wraps (a fifth of
        # its cost), opened and closed next to the ends of the record's
        # interval, so both clocks give the span nearly one length
        if torch._C._autograd._profiler_enabled():
            self.region = torch._C._autograd._record_function_with_args_enter(
                self.name)
        with _lock:
            self.buffer = _records
            if len(_records) < CAPACITY:
                index = len(_records)
                self.root = index if root is None else root
                _records.append(_record(Record, (
                    self.name, t0, None, self.parent, self.root, self.counts,
                    None)))
            else:
                index = None
                self.root = root
                _dropped += 1
        self.index = index
        dev = self.device
        # a span that found the buffer full has nowhere to keep a device
        # time, so it takes no events
        if dev is not None and index is not None:
            if not isinstance(dev, torch.device):
                dev = torch.device(dev)
            if dev.type == "cuda":
                self.events = _events(dev)
                self.events[1].record(self.events[0])
        stack.append((index, self.root))
        return self

    def __exit__(self, *exc) -> bool:
        self.stack.pop()
        events = self.events
        if events is not None:
            events[2].record(events[0])
        if self.region is not None:
            _torch._C._autograd._record_function_with_args_exit(self.region)
        t1 = _now()
        if self.index is not None:
            self.buffer[self.index] = _record(Record, (
                self.name, self.t0_ns, t1, self.parent, self.root,
                self.counts, None))
            # a start() meanwhile made a new buffer: these events are not
            # its to read, and are let go
            if events is not None and self.buffer is _records:
                _pending.append((self.index, events[0].device, events[1],
                                 events[2]))
        return False

    def count(self, **counts) -> None:
        """Add counts known only inside the span."""
        self.counts = {**(self.counts or {}), **counts}


def _events(device) -> tuple:
    """The current stream of the CUDA ``device`` and a pair of timed
    events to record on it."""
    cuda = _torch.cuda
    return (cuda.current_stream(device), cuda.Event(enable_timing=True),
            cuda.Event(enable_timing=True))


def span(name: str, device=None, **counts):
    """A context for one region of the program, named ``name``, with the
    integer ``counts`` it moves (``bytes=...``); ``device`` (a CUDA
    device) adds the region's device time on that device's current stream.
    The context's ``count(**counts)`` adds counts known only inside it.
    Off, this is one flag read."""
    if not _on:
        return _OFF
    return _Span(name, device, counts or None)


def start() -> None:
    """Turn the recorder on with an empty buffer."""
    global _on, _records, _pending, _dropped, _local, _torch
    import torch

    _torch = torch
    with _lock:
        _records, _pending, _dropped = [], [], 0
        _local = threading.local()  # spans open now close on their own stack
    _on = True


def stop() -> None:
    """Turn the recorder off; what it kept stays readable."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def records() -> list[Record]:
    """The records kept since the last :func:`start`, in the order their
    spans opened."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """How many spans found the buffer full since the last :func:`start`."""
    return _dropped


def resolve() -> None:
    """Read the device time of every closed span with CUDA events: one
    synchronise of each device they were recorded on, then the events,
    which are then let go."""
    with _lock:
        ready, _pending[:] = list(_pending), []
        recs = _records
    for device in {p[1] for p in ready}:
        _torch.cuda.synchronize(device)
    for index, _device, ev0, ev1 in ready:
        ms = ev0.elapsed_time(ev1)
        with _lock:
            if recs is _records:  # not emptied by start() meanwhile
                _records[index] = _records[index]._replace(device_ms=ms)


# ----------------------------------------------------------------------
# The profiler
# ----------------------------------------------------------------------


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (created if missing) as ``trace-<pid>-<ns>.json``: CPU
    activity, plus CUDA activity on a machine with a CUDA device, and the
    program's spans, each a ``record_function`` region of its name.  Where
    the recorder was off, it is started for the region, and the file's
    top-level ``melonix_spans`` holds the region's records (one object a
    record: the fields of :class:`Record`, ``device_ms`` read): their
    counts and device times, which the trace's own events do not carry.  If
    the profiler cannot start (one is already running, say) it warns and
    the region runs untraced: the work itself is the same either way."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    if torch._C._autograd._profiler_enabled():
        # a second profiler in one process does not raise: it corrupts the
        # first one's callbacks, so it is never started
        get_logger("melonix.trace").warning(
            "profiler unavailable: a profiler is already running")
    else:
        try:
            prof = profile(activities=activities)
            prof.__enter__()
        except RuntimeError as e:
            get_logger("melonix.trace").warning("profiler unavailable: %s", e)
            prof = None
    started = prof is not None and not _on
    if started:
        start()
    try:
        yield
    finally:
        if started:
            stop()
        if prof is not None:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            if started:
                resolve()
                prof.add_metadata_json("melonix_spans", json.dumps(
                    [r._asdict() for r in records()]))
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))

"""Spans around the program's functions, from the benchmark's own files.

A per-layer metric's file names the module attributes it times
(``WRAPS``).  For a traced run the harness replaces each such attribute
with a wrapper that records, for every call inside a request, a host-clock
span and, where asked, a pair of CUDA events on the current stream, plus
whatever the metric's ``note`` function reads from the call's arguments
(the shapes a roofline bound needs).  Each wrapper also names its region
for the profiler.  No program file is edited; an attribute that is no
longer there is reported and its metric reads nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import sys
import time

import torch
from torch.profiler import record_function


@dataclasses.dataclass(frozen=True)
class Wrap:
    """One attribute to time: ``target`` is ``package.module.attribute``;
    ``device`` adds CUDA events; ``note(arguments, result)`` returns a dict
    kept with the span (``arguments`` bound by name, defaults applied)."""

    target: str
    device: bool = False
    note: object = None


@dataclasses.dataclass
class Span:
    target: str
    request: int
    t0: float
    t1: float = 0.0
    events: tuple | None = None
    device_ms: float | None = None
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def host_ms(self) -> float:
        return 1e3 * (self.t1 - self.t0)


def short_name(target: str) -> str:
    """``engine.phase_vocoder.build_pv_plan`` -> ``phase_vocoder.build_pv_plan``."""
    return ".".join(target.split(".")[-2:])


class Spans:
    """The wrappers of one run.  ``request`` is the index of the request in
    progress (None outside the measured window: nothing is recorded)."""

    def __init__(self, wraps: list[Wrap], device: torch.device):
        self.device = device
        self.request: int | None = None
        self.spans: dict[str, list[Span]] = {}
        self._orig: list[tuple] = []
        merged: dict[str, list[Wrap]] = {}
        for w in wraps:
            merged.setdefault(w.target, []).append(w)
        self._targets = merged

    def install(self) -> None:
        for target, ws in self._targets.items():
            mod_name, _, attr = target.rpartition(".")
            try:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)
            except (ImportError, AttributeError) as e:
                print(f"[bench] no {target} to time ({e}): its metrics read "
                      "nothing", file=sys.stderr)
                continue
            self.spans[target] = []
            self._orig.append((mod, attr, orig))
            setattr(mod, attr, self._wrapper(target, orig, ws))

    def remove(self) -> None:
        for mod, attr, orig in reversed(self._orig):
            wrapper = getattr(mod, attr)
            # counters the program keeps on its functions (``f.launches +=
            # 1`` inside ``f``) were kept on the wrapper meanwhile
            orig.__dict__.update((k, v) for k, v in wrapper.__dict__.items()
                                 if k != "__wrapped__")
            setattr(mod, attr, orig)
        self._orig.clear()

    def _wrapper(self, target: str, orig, ws: list[Wrap]):
        timed = any(w.device for w in ws) and self.device.type == "cuda"
        notes = [w.note for w in ws if w.note is not None]
        sig = inspect.signature(orig) if notes else None
        label = short_name(target)
        spans = self.spans[target]

        def wrapper(*args, **kwargs):
            i = self.request
            with record_function(label):
                if i is None:
                    return orig(*args, **kwargs)
                span = Span(target, i, time.perf_counter())
                if timed:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                out = orig(*args, **kwargs)
                if timed:
                    ev[1].record()
                    span.events = ev
                span.t1 = time.perf_counter()
            if notes:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                for fn in notes:
                    span.notes.update(fn(bound.arguments, out))
            spans.append(span)
            return out

        # the wrapper carries the function's attributes, which the program
        # reads and updates through the name it now holds
        return functools.update_wrapper(wrapper, orig)

    def resolve(self) -> None:
        """Read every span's CUDA events (after the window)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for spans in self.spans.values():
            for s in spans:
                if s.events is not None:
                    s.device_ms = s.events[0].elapsed_time(s.events[1])
                    s.events = None

    def of(self, target: str) -> list[Span] | None:
        """The spans of ``target``, or None where it was not timed."""
        return self.spans.get(target)

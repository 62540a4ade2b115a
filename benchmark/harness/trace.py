"""The traced window: ``torch.profiler`` over a short run of requests.

It gives the device's busy time (the union of kernel, copy and memset
intervals), the window's length, the device operations that took most
time, and the idle gaps between busy intervals, each put down to the
innermost named region (a request, a program call, a timed function) the
host was in at the gap's middle.  The profiler has been seen to drop
device events in some runs, so no kernel's time is read from it: the
kernels' times come from CUDA events (``spans.py``).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.traced_window"
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: list  # [[name, seconds], ...], most time first
    idle_gaps: list  # [[region, seconds], ...], most time first


def op_name(name: str) -> str:
    """A device operation's name without its argument list (a kernel's
    C++ signature), so that the breakdown reads and sums by kernel."""
    if "::" not in name:
        return name  # copies and memsets: "Memcpy HtoD (Pageable -> Device)"
    return name.replace("(anonymous namespace)::", "").split("(")[0].strip()


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _region_at(regions, starts, t: float) -> str:
    """The innermost (latest-starting) region containing ``t``."""
    k = bisect.bisect_right(starts, t)
    for j in range(k - 1, -1, -1):
        lo, hi, name = regions[j]
        if lo <= t <= hi:
            return name
    return "harness"


def summarise(events: list) -> TraceSummary | None:
    win = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not win:
        return None
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    by_name: dict[str, float] = {}
    for e in dev:
        k = op_name(e["name"])
        by_name[k] = by_name.get(k, 0.0) + e["dur"] * 1e-6
    busy = _merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                  for e in dev if e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    busy_us = sum(hi - lo for lo, hi in busy)
    regions = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and e.get("name") != WINDOW)
    starts = [r[0] for r in regions]
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi > lo:
            name = _region_at(regions, starts, 0.5 * (lo + hi))
            gaps[name] = gaps.get(name, 0.0) + (hi - lo) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gtop = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(busy_us * 1e-6, (w1 - w0) * 1e-6,
                        [[k, v] for k, v in top], [[k, v] for k, v in gtop])


def traced_window(step, seconds: float, device: torch.device
                  ) -> TraceSummary | None:
    """Run ``step()`` (one request, named "request") under the profiler
    until ``seconds`` have passed, then read the trace (None where the
    profiler recorded no window)."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with record_function("request"):
                    step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarise(events)

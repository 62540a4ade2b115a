"""One run of one cell: set-up, the measured window, the traced window,
the metrics, and the comparison that decides ``correct``.

The request kind (``requests/<kind>.py``, named by the traffic mix) makes
the cell's inputs from the seed and sends one request at a time, a closed
loop of one client; this module times the loop, keeps a seeded sample of
the answers, and after the window hands that sample to the kind's
comparison with its plain reference.  Metrics are read by their own files
(``metrics/<name>.py``) from what the run recorded.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import sys
import time
import traceback

import numpy as np
import torch

from . import inputs
from .manifest import Manifest
from .spans import Spans
from .trace import TraceSummary, traced_window

# Top-level module names that a run of the port must not have loaded: JAX
# and the JAX package the port was written from (compared whole: the
# port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "melonix_tpu")
TRACE_SECONDS = 2.0  # the traced window's length, at most --seconds


@dataclasses.dataclass
class Request:
    index: int
    t0: float
    t1: float
    ok: bool

    @property
    def ms(self) -> float:
        return 1e3 * (self.t1 - self.t0)


@dataclasses.dataclass
class RunView:
    """What a metric's reader reads."""

    setup_s: float
    window_s: float
    audio_s: float  # seconds of input audio one request covers
    requests: list  # the window's requests that completed
    spans: Spans | None
    trace: TraceSummary | None


class Reservoir:
    """A seeded uniform sample of ``k`` answers of the window (algorithm
    R), so that every answer is as likely to be compared."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = inputs.rng(seed, 20)

    def offer(self, index: int, out) -> None:
        if self.seen < self.k:
            self.items.append((index, out))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = (index, out)
        self.seen += 1


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(workload, seconds: float, spans: Spans | None,
           sample: Reservoir | None):
    """A closed loop of one client for ``seconds``: (start, requests).
    The last request started before the close runs to its end."""
    reqs = []
    i = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        if spans is not None:
            spans.request = i
        t0 = time.perf_counter()
        try:
            out, ok = workload.request(i), True
        except Exception:  # counted as failed; the loop goes on
            traceback.print_exc(file=sys.stderr)
            out, ok = None, False
        t1 = time.perf_counter()
        if spans is not None:
            spans.request = None
        reqs.append(Request(i, t0, t1, ok))
        if ok and sample is not None:
            sample.offer(i, out)
        del out
        i += 1
    return t_start, reqs


def load_cell(manifest: Manifest, name: str, overrides: dict | None = None):
    """(cell, config, traffic, request kind) of a cell, with ``overrides``
    ({"config": {...}, "traffic": {...}}) laid over the files' values."""
    cell = manifest.cell(name)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    for key, d in (("config", config), ("traffic", traffic)):
        d.update((overrides or {}).get(key, {}))
    return cell, config, traffic, manifest.request_kind(traffic["request"])


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float, *,
             overrides: dict | None = None, control: bool = False) -> dict:
    """One run; returns the result line's object, or raises."""
    cell, config, traffic, kind = load_cell(manifest, name, overrides)
    limits = manifest.limits(name)
    wanted = manifest.metrics_for(name, trace)
    readers = {m["name"]: manifest.metric_reader(m["name"]) for m in wanted}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    workload = kind.Workload(config, traffic, seed, device)
    if control:
        workload.request = workload.control_request
    workload.request(1 << 40)  # warm the cell's shapes; no window index
    spans = None
    if trace:
        spans = Spans([w for r in readers.values()
                       for w in getattr(r, "WRAPS", ())], device)
        spans.install()
    sync(device)
    sample = Reservoir(int(traffic["check_sample"]), seed)
    t_win, reqs = window(workload, seconds, spans, sample)
    setup_s = t_win - t_start
    window_s = reqs[-1].t1 - t_win
    summary = None
    if trace:
        spans.resolve()
        count = itertools.count(reqs[-1].index + 1)
        summary = traced_window(lambda: workload.request(next(count)),
                                min(seconds, TRACE_SECONDS), device)
        spans.remove()
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    view = RunView(setup_s, window_s, workload.audio_s,
                   [r for r in reqs if r.ok], spans, summary)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(view)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(1 for r in reqs if not r.ok)
    ms = np.asarray([r.ms for r in view.requests])
    if ms.size:
        half = ms.size // 2
        print(f"[bench] {ms.size} requests in {window_s:.3f} s: median "
              f"{np.median(ms):.4f} ms, mean {ms.mean():.4f} (first half "
              f"{ms[:half].mean() if half else ms.mean():.4f}, second "
              f"{ms[half:].mean():.4f}), p95 {np.percentile(ms, 95):.4f}, "
              f"max {ms.max():.4f}", file=sys.stderr)

    kept = sample.items
    del sample
    numbers = workload.check(kept) if kept else []
    del kept
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers}
    correct = (failed == 0 and bool(checks) and set(checks) == set(limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": correct, "attempted": len(reqs), "failed": failed,
           "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = checks
    return out


def report(result: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    sys.stdout.flush()
    for k, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(f"[check] correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(root, args, t_start: float) -> int:
    manifest = Manifest(root)
    try:
        cell = manifest.cell(args.workload)
    except KeyError as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[bench] torch.cuda.is_available() is False: no card, no run",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"[bench] the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t_start)
    card = card_line()
    if card:
        result["device"]["card"] = card
        print(f"[bench] {card}", file=sys.stderr)
    return finish(result)


def finish(result: dict) -> int:
    """The last step of a run: the look for JAX and the JAX package,
    after everything else the run did (the window, the metrics, the
    comparison), then the result; 4 and no result where either was
    loaded."""
    bad = forbidden_modules()
    if bad:
        print("[bench] modules of JAX or the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 4
    report(result)
    return 0


def card_line() -> str | None:
    """The card's name and power limit from ``nvidia-smi`` (None where it
    cannot be read)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


"""Per-layer metrics from the program's own spans
(``melonix_tpu_torch.utils.tracing``).

Importing this file starts the program's recorder.  Only a ``--trace 1``
run loads the per-layer metrics' files (``manifest.metrics_for``), and
they import it, so the ``--trace 0`` runs, which give the end-to-end
metrics, run with the recorder off.  A program without the recorder
starts nothing here, and every metric read through :func:`per_request`
reads None there.

Each record of the program belongs to its request: the outermost span of
its thread (``root``), whose start lies on the clock of the harness's
``Request.t0/t1`` (``time.perf_counter``).  A record whose request began
outside every request of the measured window (the set-up's warm-up, the
traced window, the check's second render) is not read.
"""

from __future__ import annotations

import bisect

from melonix_tpu_torch.utils import tracing as _tracing

# None in a program older than its recorder
RECORDER = _tracing if hasattr(_tracing, "start") else None
if RECORDER is not None:
    RECORDER.start()


def per_request(view, value) -> float | None:
    """The mean over the window's completed requests of the sum, over the
    program's records in each, of ``value(record, records)`` (a number, or
    None for a record it does not read).  None where no record gave a
    number (a CPU run makes no copy between devices), where the recorder
    dropped records in the window, or where there is no recorder."""
    reqs = view.requests
    if RECORDER is None or not reqs:
        return None
    RECORDER.resolve()
    recs = RECORDER.records()
    t_end_ns = reqs[-1].t1 * 1e9
    if RECORDER.dropped() and (not recs or recs[-1].t0_ns <= t_end_ns):
        return None  # the buffer filled before the window closed
    starts = [r.t0 for r in reqs]
    total, read = 0.0, False
    for rec in recs:
        if rec.root is None or rec.t1_ns is None:
            continue
        t = recs[rec.root].t0_ns * 1e-9
        k = bisect.bisect_right(starts, t) - 1
        if k < 0 or t > reqs[k].t1:
            continue
        v = value(rec, recs)
        if v is not None:
            total += v
            read = True
    return total / len(reqs) if read else None

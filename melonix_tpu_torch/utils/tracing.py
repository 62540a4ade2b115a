"""Profiling and structured logging (counterpart of
``melonix_tpu/utils/tracing.py``).

Replaces the reference's LOG(...) macro (mika314/log, used at app.cpp:144,
740, 950 etc.) with stdlib structured logging, and its nothing-at-all
profiling story with ``torch.profiler``: :func:`trace` wraps a region and
writes a Chrome trace (open it in Perfetto or ``chrome://tracing``);
:func:`annotate` names a host-side region inside a trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "melonix") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger("melonix").handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("melonix")
        root.addHandler(h)
        root.setLevel(logging.INFO)
    return logger


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir`` (created if missing) as ``trace-<pid>-<ns>.json``: CPU
    activity, plus CUDA activity on a machine with a CUDA device.  If the
    profiler cannot start (one is already running, say) it warns and the
    region runs untraced: the work itself is the same either way."""
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
    try:
        yield
    finally:
        if prof is not None:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """Named region inside a profiler trace (host-side annotation)."""
    from torch.profiler import record_function

    return record_function(name)

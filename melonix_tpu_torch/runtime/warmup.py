"""Session warm-up at file open: the first use of every path, paid early.

Counterpart of the warm-up half of ``melonix_tpu/runtime/compile_cache.py``
(``warmup_session``, ``warmup_session_async``).  The reference pays its
plan cost once, when the file opens (FFTW_MEASURE, spec.cpp:15); the
port's first-use costs are the kernel library's build and load
(``kernels/_build.py``), the per-size twiddle tables, the page-locked
mapped buffers of the live reads and each kernel's first launch.
:func:`warmup_session` renders a silent track of the session's length
through every path, so the first tile burst, render and live read after an
open find them paid.

``compile_cache.enable`` (the persistent XLA cache and its pruning) is not
ported: built code already persists across processes here, under the source
hash stamps of ``kernels/_build.py`` (``build/kernels/``) and
``runtime/native.py`` (``build/native/``).

Unlike the JAX function, the warm-up swallows nothing: a build or launch
failure raises, since the port has no fallback that would hide the card or
a kernel.  :func:`warmup_session_async` keeps the exception on its thread
(``.error``), writes it to stderr and re-raises it from ``join``.
"""

from __future__ import annotations

import sys
import threading
import traceback

import numpy as np


def warmup_session(
    n_samples: int,
    rate: int,
    *,
    engines: tuple[str, ...] = ("granular", "pv"),
    columns: bool = True,
    pitch: bool = False,
    device=None,
) -> None:
    """Run every path a session over ``n_samples`` will use once, on a
    silent track of that length with one marker at mid-track, on
    ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain twins).

    In order: the kernel library (CUDA only), ``render_track`` (granular),
    ``render_track_pv`` and the live stream's reads (``"pv"``: 2048 at
    t = 0, then every read size the player issues from a quarter of the
    way in and from 0.2 s before the end), ``spectrogram_columns`` over
    the last 1024 samples, and ``pitch_curve`` when ``pitch``.  Raises
    whatever a path raises.
    """
    from ..engine.maps import MapKnots
    from ..engine.spectral import resolve_device, track_on_device
    from ..markers import Marker

    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        from ..kernels import _build

        _build.library()
    zeros = np.zeros(max(int(n_samples), 2048), np.float32)
    wav = track_on_device(zeros, dev)
    # One marker mid-track touches the bend and warp paths an edit
    # session always uses.
    markers = [Marker(len(zeros) // 2, 57.0, 0.0, 1.0)]
    knots = MapKnots.from_markers(markers, rate, len(zeros))

    if "granular" in engines:
        from ..engine.grains import build_grain_table
        from ..engine.render import render_track

        render_track(zeros, build_grain_table(zeros), knots, device=dev)
    if "pv" in engines:
        from ..engine.phase_vocoder import render_track_pv
        from ..engine.player import PV_FIRST_READ, PV_LIVE_AHEAD
        from ..engine.pv_stream import PvStream

        render_track_pv(wav, knots)
        PvStream(wav, knots).read(2048)
        dur = len(zeros) / rate
        # every read size of the player's refill policy (first read,
        # burst, minimum), from a restart inside the track and near its end
        for t0 in (0.25 * dur, max(0.0, dur - 0.2)):
            for n_read in (2048, 4096, PV_FIRST_READ, PV_LIVE_AHEAD):
                PvStream(wav, knots, start_sec=t0).read(n_read)
    if columns:
        from ..engine.spectral import spectrogram_columns

        end = np.asarray([len(zeros)], np.int64)
        spectrogram_columns(wav, end - 1024, end)
    if pitch:
        from ..engine.pitch import pitch_curve

        pitch_curve(wav, rate)


class WarmupThread(threading.Thread):
    """A daemon thread that keeps what its target raised: ``error`` holds
    the exception (None while it runs and after a clean end), the thread
    writes it to stderr when it dies, and :meth:`join` re-raises it."""

    def __init__(self, target, args=(), kwargs=None, *,
                 name: str = "melonix-warmup"):
        super().__init__(name=name, daemon=True)
        self._call = (target, tuple(args), dict(kwargs or {}))
        self.error: BaseException | None = None

    def run(self) -> None:
        fn, args, kwargs = self._call
        try:
            fn(*args, **kwargs)
        except BaseException as e:  # kept for join(), reported here
            self.error = e
            print(f"{self.name}: the warm-up failed:", file=sys.stderr)
            traceback.print_exception(e, file=sys.stderr)

    def join(self, timeout: float | None = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


def warmup_session_async(n_samples: int, rate: int, **kw) -> WarmupThread:
    """:func:`warmup_session` on a started daemon thread named
    ``melonix-warmup`` (the file-open hook)."""
    t = WarmupThread(warmup_session, (n_samples, rate), kw)
    t.start()
    return t


def build_async() -> WarmupThread:
    """The kernel library's build and load (``kernels/_build.library``) on a
    started daemon thread named ``melonix-build``: the editor starts it
    before it decodes a file, so ``nvcc`` runs beside the decode and the
    native build."""
    from ..kernels import _build

    t = WarmupThread(_build.library, name="melonix-build")
    t.start()
    return t

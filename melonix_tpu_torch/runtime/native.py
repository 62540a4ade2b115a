"""ctypes bindings to the native C++ host runtime: grain chain, render plan
and the playback ring.

Counterpart of ``melonix_tpu/runtime/native.py``, limited to
``mlx_build_grains`` and ``mlx_build_plan`` (the granular export's host
half), ``mlx_ring_*`` (:class:`Ring`, the live player's backlog) and
``mlx_wav_info`` / ``mlx_wav_read`` (:func:`decode_wav`, the WAV import).  The
library is built from ``native/melonix_native.cpp`` alone with
``g++ -O3 -std=c++20 -fPIC -shared`` (the flags of ``native/Makefile``) into
``build/native/libmelonix_torch_native.so`` at first use, and rebuilt when
the hash of the source and flags changes.  A library that ``make -C native``
left beside the sources is never loaded.

:func:`try_load` returns ``None`` only when no C++ compiler is found; the
callers then take the NumPy walkers and reader.  A compiler that fails
raises.  ``build_grains.calls``, ``build_plan.calls`` and
``decode_wav.calls`` count the native calls, so a run can show that the
native backend did the work.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "melonix_native.cpp"
BUILD_DIR = REPO / "build" / "native"
LIB_NAME = "libmelonix_torch_native.so"
CXX_FLAGS = ("-O3", "-std=c++20", "-fPIC", "-shared")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def compiler() -> str | None:
    """The C++ compiler to build with ($CXX, else g++ or c++), or None."""
    for c in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(c) if c else None
        if path:
            return path
    return None


def build(cxx: str) -> Path:
    """Compile the library unless one of the current hash exists."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)
    return lib


@functools.cache
def try_load() -> ctypes.CDLL | None:
    """The native library (built first if needed), or None without a C++
    compiler."""
    cxx = compiler()
    if cxx is None:
        return None
    lib = ctypes.CDLL(str(build(cxx)))
    _declare(lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    lib.mlx_build_grains.restype = ctypes.c_int64
    lib.mlx_build_grains.argtypes = [
        f32p,  # wav
        ctypes.c_int64,  # n
        ctypes.c_int32,  # preferred grain size
        i32p,  # out starts (capacity n/2+1)
        i32p,  # out lengths
        ctypes.c_int64,  # capacity
    ]

    lib.mlx_build_plan.restype = ctypes.c_int64
    lib.mlx_build_plan.argtypes = [
        i32p, i32p, ctypes.c_int64,  # grain starts/lens, count
        f64p, f64p, f64p, ctypes.c_int64,  # knot ks/ts/bends, count
        ctypes.c_double, ctypes.c_double,  # sample_rate, duration
        ctypes.c_double, ctypes.c_int64, ctypes.c_int32,  # cursor, min_out, pgs
        i32p, i32p, f32p, i64p, i32p,  # out arrays
        ctypes.c_int64,  # cap
        i32p,  # tail_zeros
    ]

    vp = ctypes.c_void_p
    lib.mlx_ring_new.restype = vp
    lib.mlx_ring_new.argtypes = [ctypes.c_int64]
    lib.mlx_ring_free.restype = None
    lib.mlx_ring_free.argtypes = [vp]
    lib.mlx_ring_avail.restype = ctypes.c_int64
    lib.mlx_ring_avail.argtypes = [vp]
    lib.mlx_ring_write.restype = ctypes.c_int64
    lib.mlx_ring_write.argtypes = [vp, f32p, ctypes.c_int64]
    lib.mlx_ring_read.restype = ctypes.c_int64
    lib.mlx_ring_read.argtypes = [vp, f32p, ctypes.c_int64]
    lib.mlx_ring_clear.restype = None
    lib.mlx_ring_clear.argtypes = [vp]

    lib.mlx_wav_info.restype = ctypes.c_int32
    lib.mlx_wav_info.argtypes = [ctypes.c_char_p, i64p, i32p, i32p]
    lib.mlx_wav_read.restype = ctypes.c_int32
    lib.mlx_wav_read.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64,
                                 ctypes.c_int32]


class Ring:
    """Lock-free single-producer single-consumer float32 ring
    (``mlx_ring_*``): the render producer and the audio-callback consumer
    never contend.  ``clear`` may come from any thread; the consumer applies
    it at its next ``avail``/``read``.  A write that does not fit raises:
    losing audio must be loud."""

    def __init__(self, lib: ctypes.CDLL, capacity: int):
        self._lib = lib
        self._h = lib.mlx_ring_new(capacity)

    def avail(self) -> int:
        return int(self._lib.mlx_ring_avail(self._h))

    __len__ = avail

    def write(self, chunk: np.ndarray) -> None:
        chunk = np.ascontiguousarray(chunk, np.float32)
        wrote = int(self._lib.mlx_ring_write(
            self._h, chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(chunk)))
        if wrote != len(chunk):
            raise RuntimeError(
                f"playback ring overflow: wrote {wrote}/{len(chunk)} samples")

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.float32)
        got = int(self._lib.mlx_ring_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n))
        return out[:got]

    def clear(self) -> None:
        self._lib.mlx_ring_clear(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None) is not None:
            self._lib.mlx_ring_free(self._h)
            self._h = None

    __del__ = close


def build_plan(lib: ctypes.CDLL, grains, knots, start_cursor: float, min_out,
               pgs: int):
    """Native render-plan walk; returns the same arrays as the NumPy walk."""
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    g_starts = np.ascontiguousarray(grains.starts, np.int32)
    g_lens = np.ascontiguousarray(grains.lengths, np.int32)
    ks = np.ascontiguousarray(knots.samples, np.float64)
    ts = np.ascontiguousarray(knots.times, np.float64)
    bends = np.ascontiguousarray(knots.bends, np.float64)
    # Warp repetition can revisit grains, so the step count isn't bounded by
    # the grain count; grow the buffers until the chain completes.
    cap = max(16, 4 * len(g_starts) + 64)
    while True:
        out_start = np.zeros(cap, np.int32)
        out_len = np.zeros(cap, np.int32)
        out_rate = np.zeros(cap, np.float32)
        out_sz = np.zeros(cap, np.int64)
        out_seam = np.zeros(cap, np.int32)
        tail = np.zeros(1, np.int32)
        count = lib.mlx_build_plan(
            g_starts.ctypes.data_as(i32p), g_lens.ctypes.data_as(i32p),
            len(g_starts),
            ks.ctypes.data_as(f64p), ts.ctypes.data_as(f64p),
            bends.ctypes.data_as(f64p), len(ks),
            float(knots.sample_rate), float(knots.duration()),
            float(start_cursor), -1 if min_out is None else int(min_out),
            int(pgs),
            out_start.ctypes.data_as(i32p), out_len.ctypes.data_as(i32p),
            out_rate.ctypes.data_as(f32p), out_sz.ctypes.data_as(i64p),
            out_seam.ctypes.data_as(i32p), cap, tail.ctypes.data_as(i32p),
        )
        if count < cap:
            break
        cap *= 4
    build_plan.calls += 1
    return (
        out_start[:count].copy(),
        out_len[:count].copy(),
        out_rate[:count].copy(),
        out_sz[:count].copy(),
        out_seam[:count].copy(),
        int(tail[0]),
    )


def build_grains(lib: ctypes.CDLL, wav: np.ndarray, pgs: int):
    """Native grain chain over a contiguous float32 track."""
    from ..engine.grains import GrainTable

    n = len(wav)
    cap = max(n // 2 + 2, 16)
    starts = np.zeros(cap, np.int32)
    lengths = np.zeros(cap, np.int32)
    count = lib.mlx_build_grains(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        pgs,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
    )
    build_grains.calls += 1
    return GrainTable(starts[:count].copy(), lengths[:count].copy())


def decode_wav(lib: ctypes.CDLL, path: str, *, mono: bool = True):
    """Native WAV decode: ``(float32 (n,) or (n, ch), rate)``.

    The two-call protocol of the reference's native decoders:
    ``mlx_wav_info`` sizes the buffer, ``mlx_wav_read`` fills it, either
    interleaved or downmixed (the channels summed in float32 and times
    ``1.0f / ch``).  One channel, or ``mono``, gives ``(n,)``.  A nonzero
    return code raises ValueError."""
    n = ctypes.c_int64()
    ch = ctypes.c_int32()
    rate = ctypes.c_int32()
    rc = lib.mlx_wav_info(path.encode(), ctypes.byref(n), ctypes.byref(ch),
                          ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"{path}: not a decodable WAV (native rc {rc})")
    frames, channels = int(n.value), int(ch.value)
    shape = (frames,) if mono or channels == 1 else (frames, channels)
    out = np.zeros(shape, np.float32)
    rc = lib.mlx_wav_read(path.encode(),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          frames, 1 if mono else 0)
    if rc != 0:
        raise ValueError(f"{path}: native WAV read failed (rc {rc})")
    decode_wav.calls += 1
    return out, int(rate.value)


build_plan.calls = 0
build_grains.calls = 0
decode_wav.calls = 0

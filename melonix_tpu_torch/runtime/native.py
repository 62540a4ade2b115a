"""ctypes bindings to the native C++ host runtime: grain chain, render plan
and the playback ring.

Counterpart of ``melonix_tpu/runtime/native.py``: ``mlx_build_grains``
and ``mlx_build_plan`` (the granular export's host half), ``mlx_ring_*``
(:class:`Ring`, the live player's backlog), the waveform min/max pyramid
``mlx_calc_picks`` / ``mlx_minmax_range`` (:func:`calc_picks`,
:func:`minmax_range`), the LRU map ``mlx_lru_*`` (:class:`Lru`) and the
decoders' two-call ``mlx_<codec>_info`` / ``mlx_<codec>_read`` pairs
(:func:`decode_wav`, :func:`decode_flac`, :func:`decode_mp3`,
:func:`decode_vorbis`, the audio import).  Every count, index and buffer
size is checked in Python before it reaches C.  The library is built from the
``SRCS`` of ``native/Makefile`` (``melonix_native.cpp`` and the FLAC, MP3
and Vorbis decoders) with its flags, ``g++ -O3 -std=c++20 -fPIC``, one
compiler process a source, all at once, then linked ``-shared`` into
``build/native/libmelonix_torch_native.so`` at first use; it is rebuilt
when the hash of the sources, the headers they include and the flags
changes.  A library that ``make -C native`` left beside the sources is
never loaded.

:func:`try_load` returns ``None`` only when no C++ compiler is found; the
callers then take the NumPy walkers and WAV reader.  A compiler that fails
raises.  ``build_grains.calls``, ``build_plan.calls`` and each decoder's
``.calls`` count the native calls, so a run can show that the native
backend did the work.
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
NATIVE = REPO / "native"
SOURCES = tuple(NATIVE / f for f in ("melonix_native.cpp", "flac_decode.cpp",
                                     "mp3_decode.cpp", "vorbis_decode.cpp"))
HEADERS = (NATIVE / "mp3_tables.h", NATIVE / "pcm_cache.h")
BUILD_DIR = REPO / "build" / "native"
LIB_NAME = "libmelonix_torch_native.so"
CXX_FLAGS = ("-O3", "-std=c++20", "-fPIC")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in SOURCES + HEADERS:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def compiler() -> str | None:
    """The C++ compiler to build with ($CXX, else g++ or c++), or None."""
    for c in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(c) if c else None
        if path:
            return path
    return None


def build_library() -> Path | None:
    """Build the library without loading it (a launcher builds before it
    starts its ranks); None without a C++ compiler."""
    cxx = compiler()
    return None if cxx is None else build(cxx)


def build(cxx: str) -> Path:
    """Compile the library unless one of the current hash exists."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in SOURCES]
    try:
        # one compiler a source, all at once; each is waited for before any
        # failure is raised, and the link waits for them all
        cmds = [[cxx, *CXX_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        errs = [proc.communicate()[1] for proc in procs]
        for cmd, proc, err in zip(cmds, procs, errs):
            _raise_on_failure(cmd, proc.returncode, err)
        cmd = [cxx, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _raise_on_failure(cmd, res.returncode, res.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    stamp.write_text(digest)
    return lib


def _raise_on_failure(cmd: list[str], rc: int, stderr: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({rc}):\n{stderr}")


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

    lib.mlx_calc_picks.restype = ctypes.c_int32
    lib.mlx_calc_picks.argtypes = [f32p, ctypes.c_int64, f32p, f32p,
                                   ctypes.c_int64]
    lib.mlx_minmax_range.restype = None
    lib.mlx_minmax_range.argtypes = [
        f32p, ctypes.c_int64,  # wav
        f32p, f32p, ctypes.c_int32,  # mins, maxs (flattened), n_levels
        i64p, ctypes.c_int64,  # queries (start,end pairs), n_queries
        f32p, f32p,  # out min, out max
    ]

    vp = ctypes.c_void_p
    lib.mlx_lru_new.restype = vp
    lib.mlx_lru_new.argtypes = [ctypes.c_int64]
    lib.mlx_lru_free.restype = None
    lib.mlx_lru_free.argtypes = [vp]
    lib.mlx_lru_get.restype = ctypes.c_int64
    lib.mlx_lru_get.argtypes = [vp, ctypes.c_int64]
    lib.mlx_lru_put.restype = ctypes.c_int64
    lib.mlx_lru_put.argtypes = [vp, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.mlx_lru_size.restype = ctypes.c_int64
    lib.mlx_lru_size.argtypes = [vp]

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

    # the decoders' two-call protocol: info (frames, channels, rate and,
    # but for WAV, bits) sizes the buffer, read fills it
    for prefix in ("wav", "flac", "mp3", "vorbis"):
        info = getattr(lib, f"mlx_{prefix}_info")
        info.restype = ctypes.c_int32
        info.argtypes = [ctypes.c_char_p, i64p, i32p, i32p] + (
            [] if prefix == "wav" else [i32p])
        read = getattr(lib, f"mlx_{prefix}_read")
        read.restype = ctypes.c_int32
        read.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int32]


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


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pyramid_levels(n: int) -> list[int]:
    """Block counts of the waveform pyramid's levels over ``n`` samples:
    level l holds ``n >> (l + 1)`` blocks and exists while
    ``n > 2 ** (l + 1)`` (app.cpp:352-366)."""
    sizes = []
    while n > 1 << (len(sizes) + 1):
        sizes.append(n >> (len(sizes) + 1))
    return sizes


def calc_picks(lib: ctypes.CDLL, wav) -> tuple[int, np.ndarray, np.ndarray]:
    """The waveform min/max pyramid of a track (``mlx_calc_picks``):
    ``(levels, mins, maxs)``, every level's blocks one after another in
    ``mins`` and ``maxs`` (level l at the sum of the block counts before
    it, :func:`pyramid_levels`)."""
    wav = np.ascontiguousarray(wav, np.float32)
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got shape {wav.shape}")
    n = len(wav)
    cap = sum(pyramid_levels(n))
    mins = np.zeros(cap, np.float32)
    maxs = np.zeros(cap, np.float32)
    levels = int(lib.mlx_calc_picks(_f32p(wav), n, _f32p(mins), _f32p(maxs),
                                    cap))
    if levels < 0:
        raise RuntimeError(f"mlx_calc_picks: {cap} floats too few for {n}")
    return levels, mins, maxs


def minmax_range(lib: ctypes.CDLL, wav, mins, maxs, levels: int, queries
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Exact min and max of ``wav[start:end]`` for each (start, end) row of
    ``queries`` (``mlx_minmax_range`` over :func:`calc_picks`' pyramid); a
    row with ``start >= end`` gives ``wav[start]``.  A query outside the
    track (an end below 0 or at or past ``len(wav)``), a level count the
    track does not have or buffers too short for it raise ValueError."""
    wav = np.ascontiguousarray(wav, np.float32)
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    q = np.ascontiguousarray(queries, np.int64)
    n = len(wav)
    sizes = pyramid_levels(n)
    if wav.ndim != 1 or not 0 <= levels <= len(sizes):
        raise ValueError(f"{levels} levels for a track of shape {wav.shape} "
                         f"(it has {len(sizes)})")
    need = sum(sizes[:levels])
    if mins.shape != maxs.shape or mins.ndim != 1 or len(mins) < need:
        raise ValueError(f"mins {mins.shape} / maxs {maxs.shape}: {levels} "
                         f"levels need {need} floats each")
    if q.ndim != 2 or q.shape[1] != 2:
        raise ValueError(f"queries must be (n, 2), got {q.shape}")
    bad = (q < 0) | (q >= n)
    if bad.any():
        s, e = (int(v) for v in q[int(np.argmax(bad.any(axis=1)))])
        raise ValueError(f"query ({s}, {e}) outside the track [0, {n})")
    out_min = np.zeros(len(q), np.float32)
    out_max = np.zeros(len(q), np.float32)
    lib.mlx_minmax_range(
        _f32p(wav), n, _f32p(mins), _f32p(maxs), levels,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(q),
        _f32p(out_min), _f32p(out_max))
    return out_min, out_max


class Lru:
    """Least-recently-used map of int64 keys to non-negative int64 values
    with a fixed capacity (``mlx_lru_*``, the reference's spectrum caches,
    spec.cpp:18-42).  ``get`` touches the key's recency; ``put`` past the
    capacity evicts the oldest key."""

    def __init__(self, lib: ctypes.CDLL, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        self._lib = lib
        self._h = lib.mlx_lru_new(capacity)

    def _handle(self):
        if self._h is None:
            raise ValueError("the LRU map is closed")
        return self._h

    def get(self, key: int) -> int | None:
        """The key's value (now the most recent), or None if absent."""
        v = int(self._lib.mlx_lru_get(self._handle(), key))
        return None if v < 0 else v

    def put(self, key: int, value: int) -> int | None:
        """Insert or update; returns the evicted key's value, or None."""
        if value < 0:
            raise ValueError(f"value {value} < 0 (-1 marks a miss)")
        evicted = ctypes.c_int64(-1)
        if self._lib.mlx_lru_put(self._handle(), key, value,
                                 ctypes.byref(evicted)):
            return int(evicted.value)
        return None

    def __len__(self) -> int:
        return int(self._lib.mlx_lru_size(self._handle()))

    def close(self) -> None:
        if getattr(self, "_h", None) is not None:
            self._lib.mlx_lru_free(self._h)
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


def _decode_two_call(lib: ctypes.CDLL, prefix: str, label: str, path: str,
                     *, mono: bool) -> tuple[np.ndarray, int]:
    """Drive a native decoder's two-call protocol: ``mlx_<prefix>_info``
    sizes the buffer, ``mlx_<prefix>_read`` fills it, either interleaved or
    downmixed (the channels summed in float32 and times ``1.0f / ch``).
    Returns ``(float32 (n,) or (n, ch), rate)``: one channel, or ``mono``,
    gives ``(n,)``.  A nonzero return code raises ValueError (the
    fail-soft contract: callers keep their prior state)."""
    n = ctypes.c_int64()
    ch = ctypes.c_int32()
    rate = ctypes.c_int32()
    args = [path.encode(), ctypes.byref(n), ctypes.byref(ch),
            ctypes.byref(rate)]
    if prefix != "wav":
        args.append(ctypes.byref(ctypes.c_int32()))  # bits, unused
    rc = getattr(lib, f"mlx_{prefix}_info")(*args)
    if rc != 0:
        raise ValueError(f"{path}: not a decodable {label} (native rc {rc})")
    frames, channels = int(n.value), int(ch.value)
    shape = (frames,) if mono or channels == 1 else (frames, channels)
    out = np.zeros(shape, np.float32)
    rc = getattr(lib, f"mlx_{prefix}_read")(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, 1 if mono else 0)
    if rc != 0:
        raise ValueError(f"{path}: native {label} read failed (rc {rc})")
    return out, int(rate.value)


def decode_wav(lib: ctypes.CDLL, path: str, *, mono: bool = True):
    """Native WAV decode (``native/melonix_native.cpp``)."""
    out = _decode_two_call(lib, "wav", "WAV", path, mono=mono)
    decode_wav.calls += 1
    return out


def decode_flac(lib: ctypes.CDLL, path: str, *, mono: bool = True):
    """Native FLAC decode (``native/flac_decode.cpp``)."""
    out = _decode_two_call(lib, "flac", "FLAC", path, mono=mono)
    decode_flac.calls += 1
    return out


def decode_mp3(lib: ctypes.CDLL, path: str, *, mono: bool = True):
    """Native MPEG-1/2/2.5 Layer III decode (``native/mp3_decode.cpp``)."""
    out = _decode_two_call(lib, "mp3", "MPEG-1 L3 stream", path, mono=mono)
    decode_mp3.calls += 1
    return out


def decode_vorbis(lib: ctypes.CDLL, path: str, *, mono: bool = True):
    """Native Ogg Vorbis decode (``native/vorbis_decode.cpp``)."""
    out = _decode_two_call(lib, "vorbis", "Ogg Vorbis stream", path,
                           mono=mono)
    decode_vorbis.calls += 1
    return out


build_plan.calls = 0
build_grains.calls = 0
decode_wav.calls = 0
decode_flac.calls = 0
decode_mp3.calls = 0
decode_vorbis.calls = 0

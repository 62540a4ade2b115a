"""ctypes wrapper for the libav import/export shim (``native/libav_decode.cpp``).

Counterpart of ``melonix_tpu/io/libav.py``.  WAV, FLAC, MP3 and Ogg Vorbis
decode through the native decoders (:mod:`..runtime.native`); this shim
covers the long tail (AAC/M4A, Opus, WMA, ...) wherever the system has the
FFmpeg libraries, with no ``ffmpeg`` binary needed.  The port builds it
itself at first use into ``build/native/libmelonix_torch_av.so`` with the
probe and link flags of ``native/Makefile`` (``pkg-config``, else a compile
probe of ``<libavformat/avformat.h>``), hash-stamped like the native
runtime; a ``libmelonix_av.so`` that ``make -C native`` left beside the
source is never loaded.  It is optional: :func:`try_load` returns ``None``
where no C++ compiler, no libav headers or no libav libraries are found
(``build_error`` then says why), and the import chain goes on without it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from ..runtime import native

SOURCE = native.NATIVE / "libav_decode.cpp"
LIB_NAME = "libmelonix_torch_av.so"
_PKGS = ("libavformat", "libavcodec", "libavutil", "libswresample")
_FALLBACK_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")

build_error: str | None = None  # why the last try_load() gave None


def _pkg_config(*args: str) -> list[str] | None:
    try:
        res = subprocess.run(["pkg-config", *args], capture_output=True,
                             text=True)
    except OSError:  # no pkg-config
        return None
    return res.stdout.split() if res.returncode == 0 else None


def link_flags(cxx: str) -> tuple[list[str], list[str]] | None:
    """(compile flags, link flags) for libav, or None without its headers:
    pkg-config when it knows the packages, else a compile probe of the
    header with the default libraries (``native/Makefile:16-31``)."""
    if _pkg_config("--exists", *_PKGS) is not None:
        return (_pkg_config("--cflags", "libavformat") or [],
                _pkg_config("--libs", *_PKGS) or list(_FALLBACK_LIBS))
    probe = subprocess.run([cxx, "-x", "c++", "-fsyntax-only", "-"],
                           input="#include <libavformat/avformat.h>\n",
                           capture_output=True, text=True)
    return ([], list(_FALLBACK_LIBS)) if probe.returncode == 0 else None


def build(cxx: str) -> os.PathLike | None:
    """Compile the shim unless one of the current hash exists; None (with
    ``build_error`` set) without libav's headers or libraries."""
    global build_error
    flags = link_flags(cxx)
    if flags is None:
        build_error = "libav headers absent"
        return None
    cflags, libs = flags
    cmd_flags = [*native.CXX_FLAGS, "-shared", *cflags]
    h = hashlib.sha256(" ".join(cmd_flags + libs).encode())
    h.update(SOURCE.read_bytes())
    digest = h.hexdigest()
    lib = native.BUILD_DIR / LIB_NAME
    stamp = native.BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = native.BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *cmd_flags, "-o", str(tmp), str(SOURCE), *libs]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:  # e.g. headers without the libraries
            build_error = f"{' '.join(cmd)} failed:\n{res.stderr[-2000:]}"
            return None
        os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    finally:
        tmp.unlink(missing_ok=True)
    stamp.write_text(digest)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mlxav_open.argtypes = [ctypes.c_char_p]
    lib.mlxav_open.restype = ctypes.c_void_p
    lib.mlxav_rate.argtypes = [ctypes.c_void_p]
    lib.mlxav_rate.restype = ctypes.c_int
    lib.mlxav_channels.argtypes = [ctypes.c_void_p]
    lib.mlxav_channels.restype = ctypes.c_int
    lib.mlxav_read.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.c_longlong]
    lib.mlxav_read.restype = ctypes.c_longlong
    lib.mlxav_close.argtypes = [ctypes.c_void_p]
    lib.mlxav_close.restype = None
    lib.mlxav_last_error.argtypes = []
    lib.mlxav_last_error.restype = ctypes.c_char_p
    lib.mlxav_encode.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int]
    lib.mlxav_encode.restype = ctypes.c_int
    return lib


@functools.cache
def try_load() -> ctypes.CDLL | None:
    """The shim (built first if needed), or None where it cannot be had."""
    global build_error
    cxx = native.compiler()
    if cxx is None:
        build_error = "no C++ compiler"
        return None
    path = build(cxx)
    if path is None:
        return None
    try:
        return _bind(ctypes.CDLL(str(path)))
    except OSError as e:  # the libraries moved since the build
        build_error = str(e)
        return None


def _last_error(lib: ctypes.CDLL) -> str:
    msg = lib.mlxav_last_error()
    return msg.decode("utf-8", "replace") if msg else "unknown libav error"


def decode(path: str, *, mono: bool = True) -> tuple[np.ndarray, int]:
    """Decode any libav-readable file -> (float32, native rate).

    Streaming reads into a growing list of chunks: container duration
    estimates (VBR) are not trusted for sizing.  Raises ValueError on any
    failure (the fail-soft contract, app.cpp:628-694).
    """
    lib = try_load()
    if lib is None:
        raise ValueError("libav shim unavailable")
    handle = lib.mlxav_open(path.encode())
    if not handle:
        raise ValueError(f"libav: {_last_error(lib)}")
    try:
        rate = lib.mlxav_rate(handle)
        channels = lib.mlxav_channels(handle)
        chunk = 1 << 18  # frames a read
        buf = np.empty(chunk * channels, np.float32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        parts: list[np.ndarray] = []
        while True:
            got = lib.mlxav_read(handle, ptr, chunk)
            if got < 0:
                raise ValueError(f"libav: {_last_error(lib)}")
            if got == 0:
                break
            parts.append(buf[: got * channels].copy())
    finally:
        lib.mlxav_close(handle)
    if not parts:
        raise ValueError("libav: stream decoded to zero samples")
    x = np.concatenate(parts)
    if channels > 1:
        x = x.reshape(-1, channels)
        if mono:
            x = x.mean(axis=1).astype(np.float32)
    return x, rate


def encode(path: str, x: np.ndarray, rate: int) -> None:
    """Encode float32 (n,) or (n, ch) to ``path``; codec and container from
    the extension (AAC-in-MP4 for .m4a, Opus for .opus, Vorbis for .ogg,
    ...).  The reference exports WAV only (save-wav.cpp)."""
    lib = try_load()
    if lib is None:
        raise ValueError("libav shim unavailable")
    x = np.asarray(x, np.float32)
    channels = 1 if x.ndim == 1 else int(x.shape[1])
    flat = np.ascontiguousarray(x.reshape(-1))
    rc = lib.mlxav_encode(
        path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(flat) // channels, int(rate), channels)
    if rc != 0:
        raise ValueError(f"libav encode: {_last_error(lib)}")

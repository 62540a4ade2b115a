"""Audio import of the port (counterpart of ``melonix_tpu/io/audio.py``;
WAV only so far).

A WAV file decodes through the native host runtime's ``mlx_wav_read``, as
the reference's does, so both give the same bits: its mono downmix sums the
channels in float32 and multiplies by ``1.0f / ch``.  Only without a C++
compiler (:func:`..runtime.native.try_load` gives ``None``) does the NumPy
reader take its place.  Failure is soft: a :class:`DecodeError` is raised
and callers keep their prior state.
"""

from __future__ import annotations

import numpy as np

from .wav import read_wav


class DecodeError(RuntimeError):
    pass


def downmix_mono(x: np.ndarray) -> np.ndarray:
    """Channel downmix: mean across channels (libswresample's default
    stereo→mono matrix is 0.5/0.5, app.cpp:669-684)."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        return x.mean(axis=1).astype(np.float32)
    return x


def load_audio(path: str, *, mono: bool = True) -> tuple[np.ndarray, int]:
    """Decode the WAV file ``path`` → (float32 samples, its sample rate):
    ``(n,)`` when ``mono`` or for one channel, else ``(n, ch)``.  No
    resampling.  Other formats are not ported and raise DecodeError."""
    if not path.lower().endswith(".wav"):
        raise DecodeError(f"{path}: only WAV input is ported")
    from ..runtime import native

    lib = native.try_load()
    if lib is None:  # no C++ compiler
        x, rate = read_wav(path)
        return (downmix_mono(x) if mono else x), rate
    try:
        return native.decode_wav(lib, path, mono=mono)
    except ValueError as e:
        raise DecodeError(str(e)) from e

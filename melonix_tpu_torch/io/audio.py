"""Audio import and export of the port (counterpart of
``melonix_tpu/io/audio.py``): decode any readable file to float32 at its
native rate, encode by extension.

The reference decodes via FFmpeg's libav* + libswresample to mono float at
the file's own sample rate, with no rate conversion (app.cpp:624-741,
``out_sample_rate = codec->sample_rate``).  Here WAV, FLAC, MP3 and Ogg
Vorbis decode through the native host runtime's decoders
(``native/*.cpp``, :mod:`..runtime.native`), the same code as the JAX
package's, so both give the same bits: a mono downmix sums the channels in
float32 and multiplies by ``1.0f / ch``.  The long tail (AAC/M4A, Opus,
...) goes through the libav shim (:mod:`.libav`) when the system has the
FFmpeg libraries, else the ``ffmpeg`` binary when present.  Without a C++
compiler a WAV file still decodes through the NumPy reader.  Failure is
soft: a :class:`DecodeError` is raised and callers keep their prior state,
matching the reference's log-and-return contract (app.cpp:628-694).
"""

from __future__ import annotations

import json
import shutil
import subprocess

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


def _have_fallback() -> bool:
    """True when a long-tail decode path (libav shim or ffmpeg binary)
    exists to retry a file the native decoders rejected."""
    from . import libav

    return libav.try_load() is not None or shutil.which("ffmpeg") is not None


def _ffprobe_rate(path: str) -> int:
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "a:0",
         "-show_entries", "stream=sample_rate", "-of", "json", path],
        capture_output=True, check=True,
    )
    return int(json.loads(out.stdout)["streams"][0]["sample_rate"])


_NATIVE = (".wav", ".flac", ".ogg", ".oga", ".mp3")  # the native decoders'


def load_audio(path: str, *, mono: bool = True) -> tuple[np.ndarray, int]:
    """Decode ``path`` → (float32 samples, native sample rate): ``(n,)``
    when ``mono`` or for one channel, else ``(n, ch)``.

    Mirrors ``App::loadAudioFile``'s contract: first audio stream, mono
    downmix, no resampling.  The chain, by extension: WAV, FLAC, Ogg/OGA
    Vorbis and MP3 natively, then the libav shim, then the ``ffmpeg``
    binary, else DecodeError.  An Ogg or MP3 stream the native decoder
    rejects (Opus-in-Ogg, Layer I/II) goes on down the chain only when a
    later step exists.
    """
    from ..runtime import native

    lower = path.lower()
    lib = native.try_load() if lower.endswith(_NATIVE) else None
    if lower.endswith(".wav"):
        if lib is None:  # no C++ compiler
            x, rate = read_wav(path)
            return (downmix_mono(x) if mono else x), rate
        try:
            return native.decode_wav(lib, path, mono=mono)
        except ValueError as e:
            raise DecodeError(str(e)) from e

    # Without a native runtime (no C++ compiler) the other native formats
    # fall through to the long tail.
    if lower.endswith(".flac") and lib is not None:
        try:
            return native.decode_flac(lib, path, mono=mono)
        except ValueError as e:
            raise DecodeError(str(e)) from e

    if lower.endswith((".ogg", ".oga")) and lib is not None:
        try:
            return native.decode_vorbis(lib, path, mono=mono)
        except ValueError as e:
            # Non-Vorbis Ogg payloads (Opus, FLAC-in-Ogg, chained streams)
            # are out of the native decoder's scope.
            if not _have_fallback():
                raise DecodeError(str(e)) from e

    if lower.endswith(".mp3") and lib is not None:
        try:
            return native.decode_mp3(lib, path, mono=mono)
        except ValueError as e:
            # Layer I/II and free-format are out of the native decoder's
            # scope.
            if not _have_fallback():
                raise DecodeError(str(e)) from e

    # Long-tail codecs (AAC/M4A, Opus, WMA, ...): the system FFmpeg
    # libraries when present (the reference links these directly,
    # app.cpp:12-17), else the ffmpeg binary, else fail soft.
    from . import libav

    if libav.try_load() is not None:
        try:
            return libav.decode(path, mono=mono)
        except ValueError as e:
            if shutil.which("ffmpeg") is None:
                raise DecodeError(f"cannot decode {path!r}: {e}") from e

    if shutil.which("ffmpeg") is None:
        raise DecodeError(
            f"cannot decode {path!r}: no native decoder, libav shim, or "
            "ffmpeg binary available")
    try:
        rate = _ffprobe_rate(path)
    except (OSError, subprocess.CalledProcessError, ValueError,
            KeyError, IndexError) as e:
        raise DecodeError(f"ffprobe failed for {path!r}: {e}") from e
    args = ["ffmpeg", "-v", "error", "-i", path, "-map", "a:0"]
    if mono:
        args += ["-ac", "1"]
    args += ["-f", "f32le", "-ar", str(rate), "-"]
    try:
        out = subprocess.run(args, capture_output=True, check=True)
    except subprocess.CalledProcessError as e:
        raise DecodeError(
            f"ffmpeg failed for {path!r}: {e.stderr.decode()[:500]}") from e
    return np.frombuffer(out.stdout, "<f4").astype(np.float32), rate


# Extensions write_audio can encode (single source of truth for the UI).
WRITABLE_EXTENSIONS = (".wav", ".flac", ".m4a", ".aac", ".opus", ".ogg",
                       ".mp3")


def write_audio(path: str, x: np.ndarray, rate: int) -> None:
    """Encode by extension: WAV/FLAC natively, anything else (M4A/AAC,
    Opus, Ogg, MP3, ...) through the libav shim.  The reference exports WAV
    only (save-wav.cpp); the rest is an added capability."""
    lower = path.lower()
    if lower.endswith(".wav"):
        from .wav import write_wav

        write_wav(path, x, rate)
        return
    if lower.endswith(".flac"):
        from .flac import write_flac

        write_flac(path, x, rate)
        return
    from . import libav

    if libav.try_load() is None:
        raise DecodeError(
            f"cannot encode {path!r}: libav shim unavailable (use .wav/.flac)")
    try:
        libav.encode(path, x, rate)
    except ValueError as e:
        raise DecodeError(str(e)) from e

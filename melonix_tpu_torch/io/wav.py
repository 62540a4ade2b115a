"""Minimal RIFF/WAV codec.

The reference hand-writes a PCM16 mono RIFF container (save-wav.cpp:17-48).
Note its data-chunk size field is written as ``fileLength - dataChunkPos + 8``
— a small spec deviation (should be ``- 8``); per SURVEY.md we implement the
*intended* correct container.  Multi-channel and float32 formats are added
capabilities (BASELINE.json stereo config).
"""

from __future__ import annotations

import struct

import numpy as np


def write_wav(path: str, pcm: np.ndarray, sample_rate: int, *, dtype: str = "int16") -> None:
    """Write a WAV file.

    ``pcm``: float32 in [-1, 1] (shape (n,) or (n, channels)) or int16.
    ``dtype``: "int16" (reference path: float → int16 by * 32767,
    app.cpp:1209-1212) or "float32" (IEEE float WAV).
    """
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, channels = pcm.shape

    if dtype == "int16":
        if pcm.dtype != np.int16:
            # Reference quantization: static_cast<int16_t>(pcm[i] * 32767.)
            # (truncation toward zero, app.cpp:1212).
            pcm = np.trunc(pcm.astype(np.float64) * 32767.0).astype(np.int16)
        fmt_tag, bits = 1, 16
        data = pcm.astype("<i2").tobytes()
    elif dtype == "float32":
        fmt_tag, bits = 3, 32
        data = pcm.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported dtype {dtype}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_tag, channels, sample_rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 array (n,) or (n, ch), sample_rate).

    Handles PCM 8/16/24/32-bit and IEEE float32/64, including the reference's
    slightly off data-chunk size by clamping to the actual payload.
    """
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), 1)
                continue
            if csize & 1:
                f.seek(1, 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    fmt_tag, channels, rate, _br, _ba, bits = struct.unpack("<HHIIHH", fmt[:16])
    if fmt_tag == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: subformat GUID leads with tag
        fmt_tag = struct.unpack("<H", fmt[24:26])[0]

    if fmt_tag == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8)
            raw = raw[: len(raw) // 3 * 3].reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif fmt_tag == 3:  # IEEE float
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {fmt_tag}")

    if channels > 1:
        x = x[: len(x) // channels * channels].reshape(-1, channels)
    return x, int(rate)

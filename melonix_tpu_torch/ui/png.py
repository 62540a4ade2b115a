"""Minimal PNG encoder (stdlib-only: zlib + struct) for headless snapshots.

Counterpart of ``melonix_tpu/ui/png.py``: the same bytes for the same
raster, and the same optional Pillow JPEG encoder for the frame loop.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """Encode an (H, W, 3) uint8 RGB array as PNG bytes."""
    img = np.asarray(img)
    if not (img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8):
        raise ValueError(f"encode_png: want (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB array as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


try:  # optional C-speed encoder for the interactive frame loop
    from PIL import Image as _PILImage
except ImportError:  # a machine without Pillow serves PNG frames
    _PILImage = None


def encode_frame(img: np.ndarray, quality: int = 88) -> tuple[bytes, str]:
    """Encode a frame for the interactive loop: (bytes, mime type).

    JPEG through Pillow where it is installed (a C encoder); the stdlib PNG
    encoder at level 1 elsewhere.  ``chip_smoke.py`` phase 24 times the
    frame loop with whichever of the two the machine has."""
    if _PILImage is not None:
        import io

        buf = io.BytesIO()
        _PILImage.fromarray(img).save(buf, "JPEG", quality=quality)
        return buf.getvalue(), "image/jpeg"
    return encode_png(img, level=1), "image/png"

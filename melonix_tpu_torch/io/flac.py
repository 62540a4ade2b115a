"""FLAC encoder: lossless compressed export (and decoder fixtures).

Counterpart of ``melonix_tpu/io/flac.py``; it writes the same bytes for the
same input.  The reference exports PCM16 WAV only (save-wav.cpp:17-48) and
relies on FFmpeg to *read* compressed audio (app.cpp:624-741).  This is a
subset encoder producing spec-conforming streams with fixed-predictor
(order 0-2) Rice coding, verbatim/constant fallbacks, and optional stereo
decorrelation; every stream it writes decodes bit-exactly through the
native C++ decoder (``native/flac_decode.cpp``) and any standard FLAC tool.

Kept in NumPy on the host: encoding is a one-shot export path (like the
reference's exportWav loop, app.cpp:1194-1215), not device work.
"""

from __future__ import annotations

import numpy as np

_CRC8_POLY = 0x07
_CRC16_POLY = 0x8005


def _crc8_table():
    t = np.zeros(256, np.uint8)
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ _CRC8_POLY if c & 0x80 else c << 1) & 0xFF
        t[i] = c
    return t


def _crc16_table():
    t = np.zeros(256, np.uint16)
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ _CRC16_POLY if c & 0x8000 else c << 1) & 0xFFFF
        t[i] = c
    return t


_T8 = _crc8_table()
_T16 = _crc16_table()


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_T8[c ^ b])
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_T16[((c >> 8) ^ b) & 0xFF]) ^ ((c << 8) & 0xFFFF)
    return c


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def u(self, value: int, bits: int) -> None:
        assert bits >= 0 and 0 <= value < (1 << bits), (value, bits)
        self.acc = (self.acc << bits) | value
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def s(self, value: int, bits: int) -> None:
        self.u(value & ((1 << bits) - 1), bits)

    def unary(self, q: int) -> None:
        while q >= 32:
            self.u(0, 32)
            q -= 32
        self.u(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.u(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _utf8_num(w: _BitWriter, v: int) -> None:
    """FLAC's extended UTF-8 coded number (frame/sample index)."""
    if v < 0x80:
        w.u(v, 8)
        return
    # `more` continuation bytes carry 6 bits each; the lead byte carries
    # 6 - more bits (0 for the 7-byte form).
    for more, lead in ((1, 0xC0), (2, 0xE0), (3, 0xF0), (4, 0xF8), (5, 0xFC), (6, 0xFE)):
        cap = 6 * more + max(6 - more, 0)
        if v < (1 << cap):
            w.u(lead | (v >> (6 * more)), 8)
            for i in range(more - 1, -1, -1):
                w.u(0x80 | ((v >> (6 * i)) & 0x3F), 8)
            return
    raise ValueError(f"frame number too large: {v}")


def _zigzag(r: np.ndarray) -> np.ndarray:
    r = r.astype(np.int64)
    return np.where(r >= 0, r << 1, (-r << 1) - 1)


def _rice_param(u: np.ndarray) -> int:
    """Parameter minimizing the Rice length for zigzagged residuals."""
    if len(u) == 0:
        return 0
    best_k, best_bits = 0, None
    for k in range(0, 15):
        bits = int(np.sum(u >> k)) + (k + 1) * len(u)
        if best_bits is None or bits < best_bits:
            best_k, best_bits = k, bits
        elif bits > best_bits * 2:
            break
    return best_k


def _encode_subframe(w: _BitWriter, s: np.ndarray, bps: int) -> None:
    """Pick constant / fixed(0-2)+Rice / verbatim, whichever is smallest."""
    n = len(s)
    s64 = s.astype(np.int64)
    if n and np.all(s64 == s64[0]):
        w.u(0, 1)
        w.u(0x00, 6)  # CONSTANT
        w.u(0, 1)  # no wasted bits
        w.s(int(s64[0]), bps)
        return

    # Candidate fixed orders with single-partition Rice residuals.
    best = None  # (bits, order, k, resid)
    for order in (0, 1, 2):
        if n <= order:
            continue
        r = s64.copy()
        for _ in range(order):
            r = np.diff(r)
        u = _zigzag(r)
        k = _rice_param(u)
        bits = order * bps + 2 + 4 + 4 + int(np.sum(u >> k)) + (k + 1) * len(u)
        if best is None or bits < best[0]:
            best = (bits, order, k, r)
    verbatim_bits = n * bps
    # k <= 14 is encodable in the 4-bit Rice field (15 is the escape code).
    if best is not None and best[0] < verbatim_bits and best[2] <= 14:
        _, order, k, r = best
        w.u(0, 1)
        w.u(0x08 | order, 6)  # FIXED
        w.u(0, 1)
        for i in range(order):
            w.s(int(s64[i]), bps)
        w.u(0, 2)  # residual method 0 (4-bit Rice)
        w.u(0, 4)  # partition order 0
        w.u(k, 4)
        for u_val in _zigzag(r):
            q = int(u_val) >> k
            w.unary(q)
            if k:
                w.u(int(u_val) & ((1 << k) - 1), k)
        return

    w.u(0, 1)
    w.u(0x01, 6)  # VERBATIM
    w.u(0, 1)
    for v in s64:
        w.s(int(v), bps)


_BS_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
             256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
             8192: 13, 16384: 14, 32768: 15}
_SS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def write_flac(
    path: str,
    x: np.ndarray,
    rate: int,
    *,
    bits: int = 16,
    block: int = 4096,
    stereo_mode: str = "independent",
) -> None:
    """Encode float32/int samples to a FLAC file.

    ``x``: (n,) mono or (n, C); floats in [-1, 1] quantize to ``bits``.
    ``stereo_mode``: "independent", "left_side", or "mid_side" (C == 2
    only) — the decorrelation modes the decoder understands.
    """
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    n, nch = x.shape
    if bits not in _SS_CODES:
        raise ValueError(f"unsupported bits: {bits}")
    if stereo_mode != "independent" and nch != 2:
        raise ValueError("stereo_mode requires exactly 2 channels")
    if np.issubdtype(x.dtype, np.floating):
        full = float(1 << (bits - 1))
        q = np.clip(np.rint(x * full), -full, full - 1).astype(np.int64)
    else:
        q = x.astype(np.int64)

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.u(block, 16)  # min block size
    si.u(block, 16)  # max block size
    si.u(0, 24)  # min frame size (unknown)
    si.u(0, 24)  # max frame size (unknown)
    si.u(rate, 20)
    si.u(nch - 1, 3)
    si.u(bits - 1, 5)
    si.u(n >> 32, 4)
    si.u(n & 0xFFFFFFFF, 32)
    for _ in range(16):
        si.u(0, 8)  # MD5 unset (decoders must accept all-zero)
    info = si.bytes()
    out += bytes([0x80]) + len(info).to_bytes(3, "big") + info  # last block

    ch_code = {"independent": nch - 1, "left_side": 8, "mid_side": 10}[stereo_mode]
    for fi, start in enumerate(range(0, max(n, 1), block)):
        bs = min(block, n - start)
        if bs <= 0:
            break
        frame = q[start : start + bs]
        w = _BitWriter()
        w.u(0x3FFE, 14)
        w.u(0, 1)  # reserved
        w.u(0, 1)  # fixed blocksize stream
        bs_code = _BS_CODES.get(bs, 7)
        w.u(bs_code, 4)
        w.u(0, 4)  # sample rate from STREAMINFO
        w.u(ch_code, 4)
        w.u(_SS_CODES[bits], 3)
        w.u(0, 1)  # reserved
        _utf8_num(w, fi)
        if bs_code == 7:
            w.u(bs - 1, 16)
        w.align()
        hdr = w.bytes()
        body = _BitWriter()
        if stereo_mode == "independent":
            subs = [(frame[:, c], bits) for c in range(nch)]
        elif stereo_mode == "left_side":
            side = frame[:, 0] - frame[:, 1]
            subs = [(frame[:, 0], bits), (side, bits + 1)]
        else:  # mid_side
            side = frame[:, 0] - frame[:, 1]
            mid = (frame[:, 0] + frame[:, 1]) >> 1
            subs = [(mid, bits), (side, bits + 1)]
        for samples, sub_bps in subs:
            _encode_subframe(body, samples, sub_bps)
        body.align()
        payload = hdr + bytes([crc8(hdr)]) + body.bytes()
        payload += crc16(payload).to_bytes(2, "big")
        out += payload

    with open(path, "wb") as f:
        f.write(out)

"""Band-limited sample-rate conversion (counterpart of
``melonix_tpu/io/resample.py``).

The reference never resamples: libswresample converts to mono float at the
file's own rate (app.cpp:669-684) and playback and export stay there.
Session workflows need real SRC (48 kHz sessions to 44.1 kHz masters).

**Polyphase as matmul.**  For a rational ratio up/down, output
``n = q*up + p`` reads source ``q*down + o_p + t`` with a per-phase
windowed-sinc row ``h_p``.  Folding the phase axis into a matrix turns the
whole resampler into

    out[q, p] = sum_r ( X2[q + r] @ H_r )[p],

where ``X2`` is the padded source viewed as (rows, down), a *reshape*, not
a gather, and ``H_r`` are small host-built (down, up) filter banks (r
ranges over the few source rows a tap window spans).  ~80 dB stopband at
the default 64 taps / Kaiser beta 8.6; the kernel stretches by the
decimation ratio when downsampling.

The banks are host float64 NumPy, rounded once to float32; the R shifted
products run on the device as float32 matmuls accumulated in float32.  They
must be IEEE float32: TF32 (what ``torch.set_float32_matmul_precision
("high")`` or ``torch.backends.cuda.matmul.allow_tf32`` turn on for cuBLAS)
keeps 10 mantissa bits and caps the 80 dB design near -60 dB, as the TPU's
default bf16-class precision capped the JAX package's near -48 dB.  So
:func:`resample` sets the process's float32 matmul precision to
``"highest"`` for its products and restores the caller's setting on the
way out, exceptions included.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from math import gcd

import numpy as np
import torch

TAPS = 64  # zero-crossing span of the prototype at the output Nyquist
BETA = 8.6  # Kaiser beta: ~80 dB stopband


@lru_cache(maxsize=16)
def _filter_banks(up: int, down: int, taps: int):
    """Host: per-shift filter banks H_r (down, up) + front pad in rows.

    Phase p (output n = q*up + p) reads source samples
    ``q*down + floor(p*down/up) + j`` for j in [-half, half); tap weights
    are the Kaiser-windowed sinc at (j - frac_p), anti-alias-scaled when
    decimating.  Weights are normalized per phase (exact DC).
    """
    ratio = down / up
    fc = 0.5 * min(1.0, 1.0 / ratio) * 0.97
    eff_taps = int(2 * -(-int(taps * max(1.0, ratio)) // 2))
    half = eff_taps // 2
    # Front pad (in source rows) so every tap index is non-negative.
    front_rows = -(-half // down)
    F = front_rows * down

    p = np.arange(up)
    o_p = (p * down) // up
    frac_p = (p * down) / up - o_p
    j = np.arange(eff_taps) - half + 1  # [-half+1, half]
    t_arg = j[None, :] - frac_p[:, None]  # (up, taps)
    window = np.where(
        np.abs(t_arg) <= half,
        np.i0(BETA * np.sqrt(np.clip(1.0 - (t_arg / half) ** 2, 0.0, 1.0)))
        / np.i0(BETA),
        0.0,
    )
    w = 2.0 * fc * np.sinc(2.0 * fc * t_arg) * window
    w = w / w.sum(axis=1, keepdims=True)  # exact DC per phase

    c_global = o_p[:, None] + j[None, :] + F  # (up, taps) >= 0
    r_idx = c_global // down
    c_idx = c_global % down
    n_shifts = int(r_idx.max()) + 1
    banks = np.zeros((n_shifts, down, up), np.float64)
    for pp in range(up):
        for tt in range(eff_taps):
            banks[r_idx[pp, tt], c_idx[pp, tt], pp] += w[pp, tt]
    return banks.astype(np.float32), front_rows, n_shifts


@contextlib.contextmanager
def ieee_float32():
    """Full float32 matmuls (no TF32, no bf16) inside, the caller's
    precision restored on the way out."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _polyphase_device(x2: torch.Tensor, banks: torch.Tensor,
                      m_out: int) -> torch.Tensor:
    """x2: (C, rows, down) padded source view; banks (R, down, up), both
    float32 on one device.  Returns (C, m_out, up): the R shifted products
    ``x2[:, r : r + m_out] @ banks[r]`` summed in float32.  The caller
    pins the precision (:func:`ieee_float32`)."""
    acc = torch.matmul(x2[:, 0:m_out], banks[0])
    for r in range(1, banks.shape[0]):
        acc += torch.matmul(x2[:, r : r + m_out], banks[r])
    return acc


def plan(n_in: int, sr_in: int, sr_out: int, taps: int = TAPS):
    """(up, down, n_out, m_out, rows, banks, front_rows) of a conversion
    of ``n_in`` samples: the shapes of :func:`_polyphase_device`'s
    operands."""
    g = gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    n_out = int(n_in * up / down)
    banks, front_rows, n_shifts = _filter_banks(up, down, taps)
    m_out = -(-n_out // up)
    return up, down, n_out, m_out, front_rows + m_out + n_shifts, banks, \
        front_rows


def resample(x, sr_in: int, sr_out: int, *, taps: int = TAPS,
             device="cuda") -> np.ndarray:
    """Resample float32 audio (n,) or (n, channels) from sr_in to sr_out,
    the filter products on ``device`` (default ``cuda``; no fallback)."""
    x = np.asarray(x, np.float32)
    if sr_in == sr_out:
        return x
    n_in = len(x)
    up, down, n_out, m_out, rows, banks, front_rows = plan(
        n_in, sr_in, sr_out, taps)
    if n_in == 0 or n_out == 0:
        return np.zeros((0,) + x.shape[1:], np.float32)

    moved = x.T if x.ndim == 2 else x[None]  # (C, n)
    xp = np.zeros((moved.shape[0], rows * down), np.float32)
    xp[:, front_rows * down : front_rows * down + n_in] = moved
    x2 = torch.from_numpy(xp.reshape(moved.shape[0], rows, down)).to(device)
    with ieee_float32():
        acc = _polyphase_device(x2, torch.from_numpy(banks).to(device), m_out)
    out = acc.cpu().numpy().reshape(moved.shape[0], m_out * up)[:, :n_out]
    return out.T if x.ndim == 2 else out[0]

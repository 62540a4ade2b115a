"""Reference-parity spectrogram columns: kernel B7 beside its plain twin.

Counterpart of ``melonix_tpu/kernels/pallas_columns.py``.  Each column is
the DFT of the window ``[end - size, end)`` anchored at the column's end
sample, samples before ``start`` attenuated by ``exp(-decay * (start - i))``
(int distance, float32 product), out-of-range samples zero, magnitudes of
the first ``size // 2`` bins divided by ``size`` (spec.cpp:44-66); with
``colormap`` they are mapped through the reference's colormap with gain
``kgain`` and packed as int32 ``0x00RRGGBB`` texels.

The TPU kernel DMA'd a slab per column, realigned it with lane rolls and ran
a four-step MXU DFT; the port's kernel (``csrc/spectrogram_columns.cu``)
takes a route by size (:func:`route`): at :data:`LARGE_SIZES` (the powers
of two 1024 ... 65,536) one transform per column held on chip
(``csrc/fft_large.cuh``: up to 16,384 points packed on the register
transform of ``csrc/fft_pair.cuh``, 65,536 on a 2-CTA cluster); at the
other sizes up to ``kernels.stft.MAX_SIZE`` the frame tile of
``csrc/fft_fourstep.cuh`` (``kernels.stft.frame_tile`` columns a CTA, at
most as many as leave a CTA for each SM); above it (1024 * j, j = 49 .. 63)
one 2-CTA cluster per column holding the frame in both CTAs' shared memory
(``csrc/fft_mixed.cuh``, table :func:`cluster_table`).  Every route is one
launch.  ``spectrogram_columns_fused`` launches it for a CUDA tensor,
runs :func:`spectrogram_columns_plain` for a CPU tensor, and raises for
anything else; ``spectrogram_columns_fused.launches`` counts its launches.
"""

from __future__ import annotations

import numpy as np
import torch

import functools

from ..utils import tracing
from . import _build
from . import stft  # the FFT routes and tables shared with B12
from .stft import (MAX_SIZE, four_step_column_table, large_twiddles,
                   unit_roots)

N1 = 128  # the TPU kernel's lane factor, kept for its size predicate
# B7's on-chip sizes (csrc/fft_large.cuh): 1024 ... 8192 packed on
# fft_pair.cuh's Pair<N / 2>, then B12's stft.LARGE_SIZES.
LARGE_SIZES = (1024, 2048, 4096, 8192) + stft.LARGE_SIZES
_PI_REF = 3.141592  # the reference's pi literal (spec-cache.cpp:86)


def supported(size: int) -> bool:
    """The sizes the TPU kernel took (``pallas_columns.supported``: 1024 *
    j, j <= 64).  On CUDA :func:`spectrogram_columns_fused` takes all of
    them by the routes of :func:`route`."""
    n2 = size // N1
    return size % N1 == 0 and 8 <= n2 <= 512 and n2 % 8 == 0


def route(size: int) -> str:
    """The kernel route B7 takes at ``size`` points, by the size alone:
    ``"large"`` (:data:`LARGE_SIZES`: one column per transform held on chip,
    65,536 on a 2-CTA cluster), ``"tile"`` (any other size up to
    :data:`MAX_SIZE`: the frame tile, ``kernels.stft.frame_tile``),
    ``"cluster"`` above it (1024 * j, j = 49 .. 63: ``fft_mixed.cuh``, one
    2-CTA cluster a column)."""
    if size in LARGE_SIZES:
        return "large"
    return "tile" if size <= MAX_SIZE else "cluster"


def cluster_plan(size: int) -> tuple[int, int]:
    """(P, m) of the cluster route at ``size`` = 2 P m points: P = 512 ..
    4096 points of each packed sub-transform, m odd, 7 .. 63 sub-sequences
    (``csrc/fft_mixed.cuh:make_mixed_plan``)."""
    if not (supported(size) and route(size) == "cluster"):
        raise ValueError(f"B7's cluster route takes 1024 * (49 .. 63) "
                         f"points, not {size}")
    low = size & -size
    return low // 2, size // low


@functools.cache
def cluster_table(size: int, device: torch.device) -> torch.Tensor:
    """The one float32 table of the cluster route at ``size`` points
    (``MixedPlan``'s offsets), computed in float64 and rounded once:
    :func:`~melonix_tpu_torch.kernels.stft.unit_roots` of 256 (pass 2) and
    of P (pass 3); (cos, sin)(2 pi x / size) for x < 128 and for x = 128 y, y <
    size / 256 (any W_N^x, x < size / 2, as one product); the m-point
    DFT's (cos, sin)(2 pi s p / m), s < m, 1 <= p <= (m - 1) / 2, at s h + p
    - 1."""
    p, m = cluster_plan(size)
    h = (m - 1) // 2
    x = np.concatenate([np.arange(128), 128 * np.arange(size // 256)])
    sp = (np.arange(m)[:, None] * np.arange(1, h + 1)[None, :]) % m
    ang = np.concatenate([2.0 * np.pi * x.astype(np.float64) / size,
                          2.0 * np.pi * sp.ravel().astype(np.float64) / m])
    tail = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(np.concatenate([
        unit_roots(256, 256), unit_roots(p, p), tail])).to(device)


def _pack_rgb(mags, kgain):
    """int32 0x00RRGGBB of pallas_columns.py:152-162 in torch ops."""
    v = torch.clamp(mags * kgain, 0.0, 255.0)
    a = (v - 85.0) * (1.0 / 85.0) * (_PI_REF / 2.0)
    r = torch.where(v < 85.0, v,
                    torch.where(v < 170.0, v * torch.cos(a), (v - 170.0) * 3.0))
    g = torch.where(v < 85.0, 0.0, torch.where(v < 170.0, v * torch.sin(a), v))
    b = torch.where(v < 170.0, 0.0, (v - 170.0) * 3.0)
    i32 = torch.int32
    return r.to(i32) * 65536 + g.to(i32) * 256 + b.to(i32)


def extract_frames(wav, starts, ends, size: int,
                   decay: float = 2.5e-4) -> torch.Tensor:
    """(B, size) float32 end-anchored frames: frame b covers samples
    [end - size, end) with end = clip(ends[b], 0, n + size) (the clip moves
    no in-range sample), samples before starts[b] scaled by ``exp(-decay *
    (start - i))`` in float32, samples out of range zero (spec.cpp:47-58)."""
    dev = wav.device
    n = wav.shape[0]
    end = ends.to(torch.int64).clamp(0, n + size)
    idx = end[:, None] - size + torch.arange(size, device=dev)[None, :]
    inb = (idx >= 0) & (idx < n)
    vals = wav[idx.clamp(0, max(n - 1, 0))]
    dist = starts.to(torch.int64)[:, None] - idx
    neg = torch.tensor(-decay, dtype=torch.float32, device=dev)
    dec = torch.where(dist > 0, torch.exp(neg * dist.to(torch.float32)), 1.0)
    return torch.where(inb, vals * dec, 0.0)


def spectrogram_columns_plain(wav, starts, ends, kgain, size: int = 32768,
                              decay: float = 2.5e-4,
                              colormap: bool = True) -> torch.Tensor:
    """(B, size // 2): float32 magnitudes, or int32 packed texels with
    ``colormap``.  :func:`extract_frames`, ``torch.fft.rfft``,
    ``|.| / size``."""
    frames = extract_frames(wav, starts, ends, size, decay)
    mags = torch.fft.rfft(frames)[:, : size // 2].abs() * (1.0 / size)
    mags = mags.to(torch.float32)
    return _pack_rgb(mags, float(kgain)) if colormap else mags


def spectrogram_columns_fused(wav, starts, ends, kgain, size: int = 32768,
                              decay: float = 2.5e-4,
                              colormap: bool = True) -> torch.Tensor:
    """B7 (``csrc/spectrogram_columns.cu``); contract of
    :func:`spectrogram_columns_plain`.  ``starts``/``ends`` are int32 (B,)
    sample ranges; ``kgain`` a float (used with ``colormap`` only)."""
    if wav.device.type == "cpu":
        return spectrogram_columns_plain(wav, starts, ends, kgain, size,
                                         decay, colormap)
    dev = _build.cuda_device(wav)
    if not supported(size):
        raise ValueError(f"B7 takes no size {size}")
    way = route(size)
    b = starts.shape[0]
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(starts, "starts", torch.int32, (b,), dev)
    _build.require(ends, "ends", torch.int32, (b,), dev)
    out = torch.empty((b, size // 2),
                      dtype=torch.int32 if colormap else torch.float32,
                      device=dev)
    lib = _build.library()
    entry, tw = {
        "large": (lib.mlx_spectrogram_columns_large, large_twiddles),
        "tile": (lib.mlx_spectrogram_columns, four_step_column_table),
        "cluster": (lib.mlx_spectrogram_columns_cluster, cluster_table),
    }[way]
    with (torch.cuda.device(dev),
          tracing.span("kernel.spectrogram_columns_fused")):
        err = entry(
            wav.data_ptr(), wav.shape[0], starts.data_ptr(), ends.data_ptr(),
            tw(size, dev).data_ptr(), out.data_ptr(), b, size, -float(decay),
            1.0 / size, float(kgain), int(colormap), _build.stream(dev),
        )
    _build.check("spectrogram_columns", err)
    spectrogram_columns_fused.launches += 1
    return out


spectrogram_columns_fused.launches = 0


def unpack_rgb(packed) -> np.ndarray:
    """0x00RRGGBB int32 (..., bins) -> uint8 (..., bins, 3)."""
    p = np.asarray(packed)
    return np.stack(
        [(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1
    ).astype(np.uint8)

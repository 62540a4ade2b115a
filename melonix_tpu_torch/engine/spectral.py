"""Spectral engine: reference-parity columns, Hann STFT, inverse STFT.

Counterpart of ``melonix_tpu/engine/spectral.py``.

* Reference columns (spec.cpp:44-66): one ``spectr_size``-point DFT per
  screen column, anchored at the column's end sample, with an exponential
  decay before its start; batched into one launch of kernel B7
  (:func:`spectrogram_columns_device`) on a CUDA tensor at the sizes the
  TPU kernel took, its plain twin elsewhere (the wrapper picks).
* The Hann |STFT| (:func:`stft_mags_device`, ``kernels.stft.stft_mags``):
  B1 at 2048 points, B12 at the other sizes the TPU kernels took, plain
  ``torch.fft.rfft`` elsewhere (as the JAX package runs XLA there).
* The plain complex STFT (:func:`stft_device`, its host wrapper
  :func:`stft`, the frame matrix :func:`extract_hop_frames`) and the
  overlap-add inverse (:func:`istft_device`, :func:`ola_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, Config
from ..kernels import _build
from ..kernels import columns as kcols
from ..kernels import pv as kpv
from ..kernels import stft as kstft
from ..kernels.columns import extract_frames as _extract_frames  # noqa: F401


def require_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA where there is none (no run
    ever moves to another device than the one asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False"
        )
    return dev


def resolve_device(device) -> torch.device:
    """:func:`require_device`, with a bare ``"cuda"`` resolved to the
    current card, ``cuda:{current_device()}``, so that it compares equal to
    the device of a tensor on that card; ``cuda:N`` stays ``cuda:N``."""
    dev = require_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def track_on_device(wav, device=None) -> torch.Tensor:
    """A track as a contiguous float32 tensor: a tensor stays on its own
    device (``device``, if given, must match); NumPy input goes to
    ``device``, default ``"cuda"`` (no fallback)."""
    if isinstance(wav, torch.Tensor):
        dev = resolve_device(wav.device if device is None else device)
        if wav.device != dev:
            raise ValueError(f"wav is on {wav.device}, asked for {dev}")
        return wav.to(torch.float32).contiguous()
    dev = resolve_device("cuda" if device is None else device)
    (t,) = _build.upload(dev, np.ascontiguousarray(wav, np.float32))
    return t


# ----------------------------------------------------------------------
# Reference-parity columns
# ----------------------------------------------------------------------


def spectrogram_columns_device(wav, start, end, size: int = DEFAULT_CONFIG.spectr_size,
                               decay: float = DEFAULT_CONFIG.spec_decay):
    """Batched reference-parity columns: (B, size // 2) float32 magnitudes
    normalized by ``size``, on the device of ``wav``: B7 at the sizes the
    TPU kernel took (``kcols.supported``), its plain twin at the rest (as
    the JAX package runs XLA there) and on a CPU tensor.  ``start``/``end``
    are int32 (B,) sample ranges."""
    return kcols.spectrogram_columns_fused(
        wav, start.to(torch.int32).contiguous(),
        end.to(torch.int32).contiguous(), 1.0, size=size, decay=decay,
        colormap=False)


def spectrogram_columns(wav, starts, ends, config: Config = DEFAULT_CONFIG,
                        *, device=None) -> np.ndarray:
    """Host convenience wrapper: NumPy in, NumPy out; runs on ``device``
    (default ``"cuda"``, no fallback)."""
    wav_dev = track_on_device(wav, device)
    dev = wav_dev.device
    out = spectrogram_columns_device(
        wav_dev,
        torch.as_tensor(np.asarray(starts, np.int32), device=dev),
        torch.as_tensor(np.asarray(ends, np.int32), device=dev),
        size=config.spectr_size, decay=config.spec_decay,
    )
    return out.cpu().numpy()


def view_column_ranges(knots, width: int, start_time: float, range_time: float):
    """Sample ranges for each screen column of a viewport.

    Column x covers warped time [t, t + pixel) with t = start_time +
    x * range_time / width; its spectrum range is [time2Sample(t),
    time2Sample(t + pixel)) (spec-cache.cpp:63-65).
    """
    x = np.arange(width + 1, dtype=np.float64)
    ts = start_time + x * range_time / width
    samples = knots.time_to_sample(ts)
    return samples[:-1].astype(np.int32), samples[1:].astype(np.int32)


# ----------------------------------------------------------------------
# Hann STFT: frames at hop * i (no centering), zeros past the end
# ----------------------------------------------------------------------


def hann_window(size: int, periodic: bool = True) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    denom = size if periodic else size - 1
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)).astype(np.float32)


def num_frames(n_samples: int, size: int, hop: int) -> int:
    if n_samples < size:
        return 1
    return 1 + (n_samples - size) // hop


def extract_hop_frames(local: torch.Tensor, size: int, hop: int,
                       n_frames: int) -> torch.Tensor:
    """(n_frames, size) frame matrix ``local[f*hop : f*hop + size]`` of a
    contiguous signal, zeros past its end, whether or not ``hop`` divides
    ``size`` (a strided view of the padded signal, ``kpv.hop_frames``)."""
    return kpv.hop_frames(local, size, hop, n_frames)


def stft_device(wav: torch.Tensor, window: torch.Tensor, size: int, hop: int,
                n_frames: int) -> torch.Tensor:
    """One-shot STFT: (n_frames, size // 2 + 1) complex64, frames at
    ``hop * i`` (no centering), zeros past the end."""
    frames = kpv.hop_frames(wav, size, hop, n_frames)
    return torch.fft.rfft(frames * window[None, :])


def stft(wav, config: Config = DEFAULT_CONFIG, *, size=None, hop=None,
         device=None):
    """Host wrapper of :func:`stft_device` on ``device`` (default
    ``"cuda"``, no fallback): returns (frames, hop), frames complex64
    NumPy."""
    size = size or config.stft_size
    hop = hop or config.stft_hop
    wav_dev = track_on_device(wav, device)
    win = torch.from_numpy(hann_window(size)).to(wav_dev.device)
    out = stft_device(wav_dev, win, size, hop,
                      num_frames(wav_dev.shape[0], size, hop))
    return out.cpu().numpy(), hop


def stft_mags_device(wav: torch.Tensor, window: torch.Tensor, size: int,
                     hop: int, n_frames: int, scale: float = 1.0
                     ) -> torch.Tensor:
    """Fused ``|STFT|`` of the first size//2 bins: (n_frames, size//2) f32,
    on the device of ``wav`` (``kstft.stft_mags``): 2048 points go to B1,
    the other shapes the TPU kernels took (``kstft.supported``) to B12, the
    rest to a plain rfft; a CPU tensor runs the twins."""
    return kstft.stft_mags(wav, window, size, hop, n_frames, scale)


# ----------------------------------------------------------------------
# Inverse STFT
# ----------------------------------------------------------------------


def istft_device(frames: torch.Tensor, window: torch.Tensor, size: int,
                 hop: int, out_len: int, normalize: bool = True) -> torch.Tensor:
    """Overlap-add inverse STFT with window-square normalization:
    ``irfft`` of each (size // 2 + 1)-bin frame, then :func:`ola_device`.
    (The JAX package's packed half-size c2r is a TPU idiom; this is its
    ``packed=False`` branch.)"""
    return ola_device(torch.fft.irfft(frames, n=size), window, size, hop,
                      out_len, normalize)


def ola_device(t: torch.Tensor, window: torch.Tensor, size: int, hop: int,
               out_len: int, normalize: bool = True,
               pre_windowed: bool = False) -> torch.Tensor:
    """Overlap-add of (F, size) time-domain frames at ``hop`` into
    ``out_len`` samples (truncated, or zero-padded past the last frame);
    with ``normalize`` divided by max(sum of window^2 taps, 1e-8)."""
    n_frames = t.shape[0]
    if not pre_windowed:
        t = t * window[None, :]
    total = (n_frames - 1) * hop + size

    def fold(cols):  # (F, size) -> (total,): sum of the frames at their hops
        return torch.nn.functional.fold(
            cols.T[None], output_size=(1, total), kernel_size=(1, size),
            stride=(1, hop)).reshape(total)

    out = fold(t.to(torch.float32))
    if normalize:
        w2 = (window * window).to(torch.float32)
        out = out / torch.clamp_min(fold(w2.expand(n_frames, size)), 1e-8)
    if total >= out_len:
        return out[:out_len]
    return torch.nn.functional.pad(out, (0, out_len - total))

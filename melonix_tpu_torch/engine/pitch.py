"""Batched pitch-curve extraction (counterpart of
``melonix_tpu/engine/pitch.py``).

A whole-track pitch curve in one pass on the device: per-frame normalized
autocorrelation (Wiener-Khinchin, McLeod's NSDF) with parabolic lag
refinement, octave-error suppression (the first peak lag within 85% of the
best wins) and a voicing decision from the clarity and the frame energy;
optionally a harmonic-product-spectrum detector and a hybrid of the two.

The autocorrelation of 2048-sample frames at 128-aligned hops is kernel B8
on a CUDA tensor and its plain twin on a CPU tensor
(``kernels/pitch.py``); other frame sizes take the plain formulation, as
the JAX package sends them to XLA.  The rest of the device half is plain
PyTorch (XLA in the JAX package); the host half is the JAX package's
float64 NumPy, copied.

Notes use the reference's A-based scale: note n <-> 55 * 2^((n-24)/12) Hz
(app.cpp:499).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, Config
from ..kernels import pitch as kpitch
from ..kernels.pv import hop_frames
from ..utils import tracing
from .spectral import track_on_device


@dataclasses.dataclass
class PitchCurve:
    f0: np.ndarray  # (F,) Hz, 0 where unvoiced
    voiced: np.ndarray  # (F,) bool
    clarity: np.ndarray  # (F,) autocorrelation peak ratio
    note: np.ndarray  # (F,) reference note scale (55 Hz = note 24)
    hop: int
    sample_rate: int

    def note_at_time(self, t: float) -> float:
        idx = int(t * self.sample_rate / self.hop)
        idx = max(0, min(idx, len(self.note) - 1))
        return float(self.note[idx])


def _parabolic(y: torch.Tensor, i: torch.Tensor, eps: float):
    """Parabolic peak refinement of per-frame index ``i`` into curve ``y``
    (F, n): the clamped fractional offset in [-0.5, 0.5], and y at i."""
    ym1 = torch.gather(y, 1, (i - 1)[:, None])[:, 0]
    y0 = torch.gather(y, 1, i[:, None])[:, 0]
    yp1 = torch.gather(y, 1, (i + 1)[:, None])[:, 0]
    denom = ym1 - 2 * y0 + yp1
    d = torch.where(denom.abs() > eps, 0.5 * (ym1 - yp1) / denom,
                    torch.zeros((), device=y.device))
    return d.clamp(-0.5, 0.5), y0


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 where none), as ``jnp.argmax``
    over a bool mask: ``torch.argmax`` takes no bool, and returns the first
    maximum, as JAX does."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def _median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median of each row, the two middle values AVERAGED for an even count
    (``jnp.nanmedian``; ``torch.median`` returns the lower one).  NaN for a
    row of no values."""
    n = x.shape[1]
    if n == 0:
        return torch.full((x.shape[0],), float("nan"), dtype=x.dtype,
                          device=x.device)
    s = torch.sort(x, dim=1).values
    if n % 2:
        return s[:, n // 2]
    return 0.5 * s[:, n // 2 - 1] + 0.5 * s[:, n // 2]


def pitch_core(w: torch.Tensor, frame: int, lag_min: int, lag_max: int,
               ac: torch.Tensor | None = None):
    """NSDF pitch analysis of mean-subtracted frames ``w`` (F, frame).

    Returns (lag, clarity, energy) per frame.  ``ac`` optionally supplies
    the per-frame linear autocorrelation (B8 computes it); otherwise it is
    derived here with ``torch.fft``.
    """
    n_frames = w.shape[0]
    dev = w.device
    if ac is None:
        spec = torch.fft.rfft(w, n=2 * frame)
        power = spec.real * spec.real + spec.imag * spec.imag
        ac = torch.fft.irfft(power, n=2 * frame)[:, :frame]
    csum = torch.cumsum(w * w, dim=1)
    total = csum[:, -1:]
    # m(tau) = sum_{j < W - tau} x^2[j] + sum_{j >= tau} x^2[j]: a flip and
    # a shift of the running energy
    head = torch.flip(csum, dims=(1,))
    tail_prev = torch.cat(
        [torch.zeros((n_frames, 1), dtype=csum.dtype, device=dev),
         csum[:, :-1]], dim=1)
    m = head + (total - tail_prev)
    nac = 2.0 * ac / m.clamp_min(1e-12)

    lags = torch.arange(frame, device=dev)
    in_range = (lags >= lag_min) & (lags <= lag_max)
    # candidates are local maxima of the NAC (MPM-style)
    prev = torch.cat([nac[:, :1], nac[:, :-1]], dim=1)
    nxt = torch.cat([nac[:, 1:], nac[:, -1:]], dim=1)
    is_peak = (nac > prev) & (nac >= nxt)
    cand = torch.where(in_range[None, :] & is_peak, nac,
                       torch.full((), -1.0, device=dev))
    peak_val = cand.max(dim=1, keepdim=True).values
    # octave-error suppression: earliest peak lag reaching 85% of the best
    first_lag = _first_true(cand >= 0.85 * peak_val)

    li = first_lag.clamp(1, frame - 2)
    delta, y0 = _parabolic(nac, li, 1e-12)
    lag = li.to(torch.float32) + delta
    energy = torch.mean(w * w, dim=1)
    return lag, y0, energy


def hps_core(w: torch.Tensor, frame: int, lag_min: int, lag_max: int,
             n_harm: int = 4):
    """Harmonic-product-spectrum detector over mean-subtracted frames, in
    the log domain on the zero-padded power spectrum.  Returns (lag,
    salience): lag at the NSDF convention (2 * frame / k for bin k),
    salience the mean log-power margin of the winning bin over the in-range
    median (about 0 for noise)."""
    dev = w.device
    spec = torch.fft.rfft(w, n=2 * frame)
    lp = torch.log(spec.real * spec.real + spec.imag * spec.imag + 1e-20)
    n_bins = lp.shape[1]
    nb = (n_bins - 1) // n_harm + 1
    hsum = sum(lp[:, ::h][:, :nb] for h in range(1, n_harm + 1))
    k = torch.arange(nb, device=dev)
    k_min = max(1, int(np.ceil(2 * frame / lag_max)))
    k_max = min(nb - 2, int(np.floor(2 * frame / lag_min)))
    in_range = (k >= k_min) & (k <= k_max)
    # subharmonic guard: the winner's own fundamental bin must be within
    # ~26 dB of the frame's strongest bin; else fall back to the raw comb
    strong = lp[:, :nb] >= (lp.max(dim=1, keepdim=True).values - 6.0)
    neg_inf = torch.full((), -float("inf"), device=dev)
    masked_strong = torch.where(in_range[None, :] & strong, hsum, neg_inf)
    masked_all = torch.where(in_range[None, :], hsum, neg_inf)
    any_strong = (in_range[None, :] & strong).any(dim=1)
    k_best = torch.where(any_strong, torch.argmax(masked_strong, dim=1),
                         torch.argmax(masked_all, dim=1))
    ki = k_best.clamp(1, nb - 2)
    dk, y0 = _parabolic(hsum, ki, 1e-9)
    kf = ki.to(torch.float32) + dk
    lag = 2.0 * frame / kf.clamp_min(1e-6)
    # in_range is one contiguous column span: its median needs no NaN mask
    med = _median_rows(hsum[:, k_min : k_max + 1])
    return lag, (y0 - med) / n_harm


def _centered_frames(wav: torch.Tensor, frame: int, hop: int, n_frames: int):
    frames = hop_frames(wav.to(torch.float32), frame, hop, n_frames)
    return frames - frames.mean(dim=1, keepdim=True)


def _pitch_device(wav: torch.Tensor, frame: int, hop: int, n_frames: int,
                  lag_min: int, lag_max: int):
    """(lag, clarity, energy) on the device of ``wav``: B8 for the shapes
    it takes, the plain formulation otherwise."""
    if kpitch.supported(frame, hop, n_frames):
        ac, w = kpitch.pitch_ac(wav, frame, hop, n_frames)
        return pitch_core(w, frame, lag_min, lag_max, ac=ac)
    return pitch_core(_centered_frames(wav, frame, hop, n_frames), frame,
                      lag_min, lag_max)


def _hps_device(wav: torch.Tensor, frame: int, hop: int, n_frames: int,
                lag_min: int, lag_max: int):
    return hps_core(_centered_frames(wav, frame, hop, n_frames), frame,
                    lag_min, lag_max)


def _host64(t: torch.Tensor) -> np.ndarray:
    with tracing.span("d2h", bytes=t.nbytes):
        return t.cpu().numpy().astype(np.float64)


def pitch_curve(
    wav,
    sample_rate: int,
    *,
    config: Config = DEFAULT_CONFIG,
    clarity_threshold: float = 0.5,
    energy_threshold: float = 1e-6,
    method: str = "nsdf",
    device=None,
) -> PitchCurve:
    """``method``: "nsdf" (autocorrelation, default), "hps" (harmonic
    product spectrum), or "hybrid": NSDF lags with HPS overriding only
    where the two disagree by exactly an octave AND the harmonic evidence
    is salient.  ``wav`` is a NumPy array or a tensor; the analysis runs on
    ``device``, which defaults to the tensor's own device, or to ``"cuda"``
    for NumPy input (no fallback)."""
    with tracing.span("pitch_curve"):
        if method not in ("nsdf", "hps", "hybrid"):
            raise ValueError(f"unknown pitch method: {method}")
        wav_dev = track_on_device(wav, device)
        n = int(wav_dev.shape[0])
        frame, hop = config.pitch_frame, config.pitch_hop
        n_frames = max(1, 1 + (n - frame) // hop) if n >= frame else 1
        lag_min = max(2, int(sample_rate / config.pitch_fmax))
        lag_max = min(frame - 2, int(sample_rate / config.pitch_fmin))
        lag, clarity, energy = _pitch_device(wav_dev, frame, hop, n_frames,
                                             lag_min, lag_max)
        lag = _host64(lag)
        if method in ("hps", "hybrid"):
            hlag, sal = _hps_device(wav_dev, frame, hop, n_frames, lag_min,
                                    lag_max)
            hlag, sal = _host64(hlag), _host64(sal)
            if method == "hps":
                lag = hlag
            else:
                octave_low = np.abs(lag - 2.0 * hlag) < 0.04 * 2.0 * hlag
                octave_high = np.abs(2.0 * lag - hlag) < 0.04 * hlag
                # sal > 2.0: white noise measures ~1.3; tonal frames 4-8.
                lag = np.where((octave_low | octave_high) & (sal > 2.0),
                               hlag, lag)
        clarity = _host64(clarity)
        energy = _host64(energy)
        with tracing.span("pitch.voicing", frames=len(lag)):
            f0 = np.where(lag > 0, sample_rate / np.maximum(lag, 1e-9), 0.0)
            voiced = ((clarity > clarity_threshold)
                      & (energy > energy_threshold))
            f0 = np.where(voiced, f0, 0.0)
            with np.errstate(divide="ignore"):
                note = np.where(
                    f0 > 0,
                    24.0 + 12.0 * np.log2(np.maximum(f0, 1e-9) / 55.0), 0.0)
            return PitchCurve(
                f0=f0.astype(np.float32),
                voiced=voiced,
                clarity=clarity.astype(np.float32),
                note=note.astype(np.float32),
                hop=hop,
                sample_rate=int(sample_rate),
            )

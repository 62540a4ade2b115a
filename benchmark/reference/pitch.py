"""Plain reference of ``pitch_curve``'s NSDF detector.

McLeod's normalised square difference over frames of ``frame`` samples at
``hop`` (zeros past the end), each minus its mean: the linear
autocorrelation by a zero-padded FFT, ``nsdf(tau) = 2 r(tau) / m(tau)``
with ``m(tau) = sum_{j < W - tau} x_j^2 + sum_{j >= tau} x_j^2``, the
earliest local maximum in the lag range reaching 85% of the best one,
refined by a parabola; voiced where the peak (the clarity) passes 0.5 and
the frame's mean energy 1e-6.  Float64 on whatever device it is given;
nothing of the program.  ``quantize`` rounds every stage's result to a
lower precision (the control).
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def curve(wav: torch.Tensor, sr: int, *, frame: int, hop: int, fmin: float,
          fmax: float, clarity_threshold: float = 0.5,
          energy_threshold: float = 1e-6,
          quantize: torch.dtype | None = None) -> dict:
    """{"note", "voiced", "f0"} as NumPy arrays, one entry a frame."""
    def q(x):
        return x if quantize is None else x.to(quantize).to(x.dtype)

    dev = wav.device
    n = int(wav.shape[0])
    n_frames = max(1, 1 + (n - frame) // hop) if n >= frame else 1
    lag_min = max(2, int(sr / fmax))
    lag_max = min(frame - 2, int(sr / fmin))
    need = (n_frames - 1) * hop + frame
    x = q(torch.nn.functional.pad(wav.to(F64), (0, max(need - n, 0))))
    w = x.unfold(0, frame, hop)[:n_frames]
    w = q(w - w.mean(dim=1, keepdim=True))
    spec = torch.fft.rfft(w, n=2 * frame)
    ac = q(torch.fft.irfft(q(spec.real ** 2 + spec.imag ** 2),
                           n=2 * frame)[:, :frame])
    del spec
    csum = torch.cumsum(w * w, dim=1)
    total = csum[:, -1:]
    before = torch.cat([torch.zeros_like(total), csum[:, :-1]], dim=1)
    m = torch.flip(csum, dims=(1,)) + (total - before)
    nac = q(2.0 * ac / m.clamp_min(1e-12))
    del ac, m, before

    lags = torch.arange(frame, device=dev)
    in_range = (lags >= lag_min) & (lags <= lag_max)
    prev = torch.cat([nac[:, :1], nac[:, :-1]], dim=1)
    nxt = torch.cat([nac[:, 1:], nac[:, -1:]], dim=1)
    peak = in_range[None, :] & (nac > prev) & (nac >= nxt)
    cand = torch.where(peak, nac, torch.full((), -1.0, dtype=F64,
                                             device=dev))
    best = cand.max(dim=1, keepdim=True).values
    first = torch.argmax((cand >= 0.85 * best).to(torch.uint8), dim=1)
    li = first.clamp(1, frame - 2)
    y_m = nac.gather(1, (li - 1)[:, None])[:, 0]
    y_0 = nac.gather(1, li[:, None])[:, 0]
    y_p = nac.gather(1, (li + 1)[:, None])[:, 0]
    den = y_m - 2.0 * y_0 + y_p
    off = torch.where(den.abs() > 1e-12, 0.5 * (y_m - y_p) / den,
                      torch.zeros((), dtype=F64, device=dev)).clamp(-0.5, 0.5)
    lag = (li.to(F64) + off).cpu().numpy()
    clarity = y_0.cpu().numpy()
    energy = (w * w).mean(dim=1).cpu().numpy()
    voiced = (clarity > clarity_threshold) & (energy > energy_threshold)
    f0 = np.where(voiced & (lag > 0), sr / np.maximum(lag, 1e-9), 0.0)
    with np.errstate(divide="ignore"):
        note = np.where(f0 > 0, 24.0 + 12.0 * np.log2(np.maximum(f0, 1e-9)
                                                      / 55.0), 0.0)
    return {"note": note, "voiced": voiced, "f0": f0}

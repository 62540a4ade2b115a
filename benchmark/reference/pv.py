"""Plain reference of the marker edit's phase-vocoder render.

What ``render_track_pv`` and ``render_session(engine="pv")`` promise,
written from the formulas and nothing of the program: the marker maps of
the reference editor (app.cpp:1020-1122), the closed-form rate integral
and its inverse, a Hann analysis at integer frame starts, the classic
phase propagation ``psi_m = psi_{m-1} + hop (omega + princarg(phi_m -
phi_{m-1} - omega d_m) / d_m)``, the optional cepstral formant warp, the
windowed overlap-add normalised by the summed squared window, and the
variable-rate linear resample at ``p(t) sr - rho(t)``.  It uses float64
throughout on whatever device it is given, with the frames it needs and no
padding, chunks, anchors or blocks.

``quantize`` names a lower precision (``torch.bfloat16``): every stage's
result is then rounded to it, which makes the control that the
comparison has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
LN2_12 = math.log(2.0) / 12.0


# ----------------------------------------------------------------------
# The marker maps (float64, first matching segment in knot order)
# ----------------------------------------------------------------------


class Knots:
    """Knots of a marker edit: (sample, time, bend) with the origin knot,
    from markers ``(sample, note, d_time, bend)`` sorted by sample."""

    def __init__(self, markers, sr: int, n: int):
        ms = sorted(markers, key=lambda m: m[0])
        s, t, b = [0.0], [0.0], [0.0]
        for m in ms:
            t.append(t[-1] + (m[0] - s[-1]) / sr + m[2])
            s.append(float(m[0]))
            b.append(float(m[3]))
        self.s, self.t, self.b = np.array(s), np.array(t), np.array(b)
        self.sr, self.n = sr, n
        self.duration = float(self.sample_to_time(np.array([n - 1.0]))[0])

    @staticmethod
    def _first(x: np.ndarray, v: np.ndarray):
        """(has, i): v in (x[i], x[i+1]] for a first i in knot order."""
        match = (v[:, None] > x[None, :-1]) & (v[:, None] <= x[None, 1:])
        return match.any(axis=1), np.argmax(match, axis=1)

    def _interp(self, x, y, v, tail):
        if len(x) > 1:
            has, i = self._first(x, v)
            with np.errstate(divide="ignore", invalid="ignore"):
                inner = y[i] + (v - x[i]) * (y[i + 1] - y[i]) / (x[i + 1] - x[i])
            tail = np.where(has, inner, tail)
        return tail

    def sample_to_time(self, v: np.ndarray) -> np.ndarray:
        out = self._interp(self.s, self.t, v,
                           self.t[-1] + (v - self.s[-1]) / self.sr)
        return np.where(v <= 0, v / self.sr, out)

    def time_to_sample(self, v: np.ndarray) -> np.ndarray:
        out = self._interp(self.t, self.s, v,
                           self.s[-1] + (v - self.t[-1]) * self.sr)
        return np.where(v <= 0, v * self.sr, out)

    def time_to_bend(self, v: np.ndarray) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            tail = self.b[-1] - (v - self.t[-1]) * self.b[-1] / (
                self.duration - self.t[-1])
        tail = np.where(np.isfinite(tail), tail, 0.0)
        tail = np.where(v > self.duration, 0.0, tail)
        out = self._interp(self.t, self.b, v, tail)
        return np.where(v <= 0, 0.0, out)


# ----------------------------------------------------------------------
# Rate integral p(t) = int_0^t 2^(bend/12), per linear-bend segment
# ----------------------------------------------------------------------


class RateMap:
    """Segments of the bend curve up to ``t_end``: the knot intervals, the
    relaxation to 0 at the duration, a unit-rate tail; ``p0`` is the exact
    integral at each segment's start and ``total`` at ``t_end``."""

    def __init__(self, k: Knots, t_end: float):
        ts = list(k.t) + [max(k.duration, float(k.t[-1])), t_end]
        bs = list(k.b) + [0.0, 0.0]
        rows, p = [], 0.0
        for i in range(len(ts) - 1):
            t0, t1, b0, b1 = ts[i], ts[i + 1], bs[i], bs[i + 1]
            if t1 <= t0:
                continue
            rows.append((t0, b0, (b1 - b0) / (t1 - t0), p))
            r0, r1 = 2.0 ** (b0 / 12.0), 2.0 ** (b1 / 12.0)
            p += (r0 * (t1 - t0) if abs(b1 - b0) < 1e-12
                  else (t1 - t0) * (r1 - r0) / ((b1 - b0) * LN2_12))
        rows = rows or [(0.0, 0.0, 0.0, 0.0)]
        self.t0, self.b0, self.slope, self.p0 = (np.array(c) for c in
                                                 zip(*rows))
        self.total = p

    def p_rho(self, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(p(t), rho(t)) at times ``t``."""
        i = np.clip(np.searchsorted(self.t0, t, side="right") - 1, 0,
                    len(self.t0) - 1)
        dt, s = t - self.t0[i], self.slope[i]
        r0 = 2.0 ** (self.b0[i] / 12.0)
        rho = 2.0 ** ((self.b0[i] + s * dt) / 12.0)
        flat = np.abs(s) < 1e-12
        with np.errstate(divide="ignore", invalid="ignore"):
            p = self.p0[i] + np.where(flat, r0 * dt,
                                      (rho - r0) / (np.where(flat, 1.0, s)
                                                    * LN2_12))
        return p, rho

    def t_of_p(self, y: np.ndarray) -> np.ndarray:
        """The time at which the integral reaches ``y``."""
        i = np.clip(np.searchsorted(self.p0, y, side="right") - 1, 0,
                    len(self.t0) - 1)
        t0, b0, s = self.t0[i], self.b0[i], self.slope[i]
        r0 = 2.0 ** (b0 / 12.0)
        dy = y - self.p0[i]
        flat = np.abs(s) < 1e-12
        with np.errstate(divide="ignore", invalid="ignore"):
            r_t = r0 + dy * s * LN2_12
            t_exp = t0 + (12.0 * np.log2(np.maximum(r_t, 1e-30)) - b0) / \
                np.where(flat, 1.0, s)
        return np.where(flat, t0 + dy / r0, t_exp)


# ----------------------------------------------------------------------
# The render
# ----------------------------------------------------------------------


def hann(size: int, device) -> torch.Tensor:
    n = torch.arange(size, dtype=F64, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / size)


def formant_gain(mag: torch.Tensor, rho: torch.Tensor, size: int,
                 n_ceps: int) -> torch.Tensor:
    """The cepstral envelope warp: coefficients ``c_q``, q = 1 ..
    n_ceps - 1, of the log magnitude over the half spectrum (weights
    {1, 2, ..., 2, 1} / size); gain ``exp(sum_q 2 c_q (cos(q theta rho) -
    cos(q theta)))``, its exponent clipped to +-6.9 (+-60 dB)."""
    dev = mag.device
    nb = size // 2 + 1
    k = torch.arange(nb, dtype=F64, device=dev)
    q = torch.arange(1, n_ceps, dtype=F64, device=dev)
    wk = torch.full((nb,), 2.0 / size, dtype=F64, device=dev)
    wk[0] = wk[-1] = 1.0 / size
    a = wk[:, None] * torch.cos(2.0 * math.pi * k[:, None] * q[None, :] / size)
    cep = torch.log(mag + 1e-8) @ a  # (F, n_ceps - 1)
    theta = 2.0 * math.pi * k / size
    g = torch.zeros_like(mag)
    for j in range(n_ceps - 1):
        qj = float(j + 1)
        g += 2.0 * cep[:, j:j + 1] * (torch.cos(qj * theta[None, :]
                                                * rho[:, None])
                                      - torch.cos(qj * theta)[None, :])
    return torch.exp(g.clamp(-6.9, 6.9))


def render(wav: torch.Tensor, markers, sr: int, *, size: int, hop: int,
           formants: bool = False, n_ceps: int = 40,
           quantize: torch.dtype | None = None) -> torch.Tensor:
    """(n_out,) float64 render of the mono track ``wav`` (any float dtype,
    on the device the reference runs on) through ``markers``."""
    def q(x):
        return x if quantize is None else x.to(quantize).to(x.dtype)

    dev = wav.device
    n = int(wav.shape[0])
    k = Knots(markers, sr, n)
    n_out = int(k.duration * sr)
    if n_out <= 0:
        return torch.zeros(0, dtype=F64, device=dev)
    if n < size:
        return torch.zeros(n_out, dtype=F64, device=dev)
    rm = RateMap(k, n_out / sr)
    n_frames = int(math.ceil(rm.total * sr / hop)) + 2
    t_m = rm.t_of_p(np.minimum(np.arange(n_frames) * hop / sr, rm.total))
    a_m = k.time_to_sample(t_m)
    starts = np.floor(np.clip(a_m, 0.0, n - 1.0)).astype(np.int64)
    da = np.maximum(np.diff(a_m, prepend=a_m[0] - hop), 1e-3)

    x = q(torch.nn.functional.pad(wav.to(F64), (0, size)))
    win = q(hann(size, dev))
    idx = (torch.from_numpy(starts).to(dev)[:, None]
           + torch.arange(size, device=dev)[None, :])
    spec = torch.fft.rfft(q(x[idx] * win[None, :]))
    mag, phi = q(spec.abs()), q(spec.angle())
    del spec, idx
    if formants:
        rho = torch.from_numpy(2.0 ** (k.time_to_bend(t_m) / 12.0)).to(dev)
        mag = q(mag * q(formant_gain(mag, rho, size, n_ceps)))

    nb = size // 2 + 1
    kk = torch.arange(nb, device=dev)
    omega = 2.0 * math.pi * kk.to(F64) / size
    d = torch.from_numpy(da).to(dev)[:, None]
    dphi = phi[1:] - phi[:-1] - omega[None, :] * d[1:]
    dphi = torch.remainder(dphi + math.pi, 2.0 * math.pi) - math.pi
    incr = q(hop * dphi / d[1:])
    acc = torch.cat([torch.zeros(1, nb, dtype=F64, device=dev),
                     q(torch.cumsum(incr, dim=0))])
    m = torch.arange(n_frames, device=dev)
    ramp = ((m[:, None] * hop * kk[None, :]) % size).to(F64) * (
        2.0 * math.pi / size)
    psi = q(phi[0][None, :] + ramp + acc)
    del dphi, incr, acc, ramp, phi

    syn = torch.polar(mag, psi)
    syn[:, 0].imag = 0.0
    syn[:, -1].imag = 0.0
    frames = q(torch.fft.irfft(syn, n=size) * win[None, :])
    del syn, mag, psi
    length = (n_frames - 1) * hop + size

    def ola(rows):
        return torch.nn.functional.fold(
            rows.T[None], output_size=(1, length), kernel_size=(1, size),
            stride=(1, hop)).reshape(length)

    y = q(ola(frames))
    del frames
    wsum = ola((win * win)[None, :].expand(n_frames, size).contiguous())
    y = q(y / wsum.clamp_min(1e-8))

    return q(lerp(y, _positions(rm, n_out, sr, dev)))


def _positions(rm: "RateMap", n_out: int, sr: int, dev) -> torch.Tensor:
    t = (np.arange(n_out, dtype=np.float64) + 1.0) / sr
    p, rho_t = rm.p_rho(t)
    return torch.from_numpy(np.maximum(p * sr - rho_t, 0.0)).to(dev)


def positions(markers, sr: int, n: int, device) -> torch.Tensor:
    """(n_out,) float64: where each output sample reads the stretched,
    normalised signal (in its samples), ``p(t) sr - rho(t)`` at
    ``t = (j + 1) / sr``."""
    k = Knots(markers, sr, n)
    n_out = int(k.duration * sr)
    return _positions(RateMap(k, n_out / sr), n_out, sr, device)


def lerp(y: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The variable-rate linear resample: ``y`` read at positions
    ``src``, clamped to its ends."""
    i0 = torch.floor(src)
    frac = src - i0
    i0 = i0.to(torch.int64)
    last = y.shape[0] - 1
    return (1.0 - frac) * y[i0.clamp(0, last)] + frac * y[
        (i0 + 1).clamp(0, last)]

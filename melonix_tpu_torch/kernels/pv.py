"""Phase-vocoder DFT kernels B1-B3 and B10 and their plain PyTorch twins.

Counterpart of ``melonix_tpu/kernels/pallas_pv.py``.  The TPU kernels ran a
four-step bf16x3 MXU DFT in a scrambled bin order; the port's kernels keep
natural bin order and the 1025-bin half spectrum throughout.  B1
(``csrc/stft_mag.cu``) and the synthesis of B3 (``csrc/pv_synth_ola_phase.cu``)
and B10 (``csrc/pv_synth_ola.cu``) share one float32 radix-2 FFT in shared
memory (``csrc/fft2048.cuh``), B3 and B10 also their synthesis and
overlap-add launches (``csrc/pv_synth.cuh``); B2 (``csrc/pv_analysis.cu``)
transforms two real frames at once on the register-resident
``csrc/fft2048_pair.cuh``.  B3's phase scan is blocked over frames and sums
in float64 (:func:`phase_scan`).

Each wrapper takes the device of its input: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the ``*_plain`` twin, anything else
raises.  The twins are the CPU path and the reference the kernels are held
to on the card.  B1-B3 and B10 take 2048-point frames only; the phase
vocoder at other frame sizes runs the natural-order formulas of
:func:`synth_ola_phase_plain` (and :func:`synth_ola_plain`) on any device
(as the JAX package runs XLA there,
``engine.phase_vocoder._stretch_chunk_core``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

FFT_N = 2048  # the only frame size the CUDA kernels take
# float32 constants of the JAX formulas, as Python floats holding f32 values
PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * np.pi))


def _no_size(size: int) -> NotImplementedError:
    return NotImplementedError(
        f"B1-B3 (B3's (re, im) and (mag, phi) entries alike) take size "
        f"{FFT_N}, got {size}: for the |STFT| at other sizes use "
        "engine.spectral.stft_mags_device (B12); the phase vocoder takes "
        "other sizes through engine.phase_vocoder (B9 and the natural-order "
        "formulas of synth_ola_phase_plain)"
    )


def _cos_sin(ang: np.ndarray) -> np.ndarray:
    """(..., 2) float32 cos and sin of float64 angles, computed in float64."""
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


@functools.cache
def twiddles(device: torch.device) -> torch.Tensor:
    """(1024, 2) float32 cos/sin(2 pi k / 2048), computed in float64 (the
    radix-2 ``fft2048.cuh`` of B1 and B3's synthesis)."""
    ang = 2.0 * np.pi * np.arange(FFT_N // 2, dtype=np.float64) / FFT_N
    return torch.from_numpy(_cos_sin(ang)).to(device)


@functools.cache
def pair_twiddles(device: torch.device) -> torch.Tensor:
    """(2176, 2) float32 cos/sin of B2's ``fft2048_pair.cuh`` pass
    twiddles, computed in float64: rows ``k2 * 128 + b`` hold 2 pi b k2 /
    2048 (k2 < 16, b < 128), then rows ``2048 + q * 8 + c`` hold 2 pi c q /
    128 (q < 16, c < 8).  The kernel applies the transform's sign."""
    k2, b = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    q, c = np.meshgrid(np.arange(16), np.arange(8), indexing="ij")
    ang = np.concatenate([(2.0 * np.pi / FFT_N) * (b * k2).ravel(),
                          (2.0 * np.pi / 128) * (c * q).ravel()])
    return torch.from_numpy(_cos_sin(ang)).to(device)


# ----------------------------------------------------------------------
# B1: |STFT| at a uniform hop
# ----------------------------------------------------------------------


def hop_frames(wav, size: int, hop: int, n_frames: int) -> torch.Tensor:
    """(n_frames, size) view of ``wav[f*hop : f*hop + size]``, zeros past
    the end."""
    need = (n_frames - 1) * hop + size if n_frames else 0
    wavp = torch.nn.functional.pad(wav, (0, max(need - wav.shape[0], 0)))
    return wavp.unfold(0, size, hop)[:n_frames]


def stft_mag_plain(wav, window, size: int, hop: int, n_frames: int,
                   scale: float = 1.0) -> torch.Tensor:
    """(n_frames, size // 2) float32: ``|rfft(win * wav[f*hop : +size])|
    * scale`` for the first size//2 bins, zeros past the end."""
    frames = hop_frames(wav, size, hop, n_frames)
    spec = torch.fft.rfft(frames * window[None, :])
    return (spec[:, : size // 2].abs() * scale).to(torch.float32)


def stft_mag(wav, window, size: int, hop: int, n_frames: int,
             scale: float = 1.0) -> torch.Tensor:
    """B1 (``csrc/stft_mag.cu``); contract of :func:`stft_mag_plain`."""
    if wav.device.type == "cpu":
        return stft_mag_plain(wav, window, size, hop, n_frames, scale)
    dev = _build.cuda_device(wav)
    if size != FFT_N:
        raise _no_size(size)
    if hop <= 0 or n_frames < 0:
        raise ValueError(f"hop {hop}, n_frames {n_frames}")
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(window, "window", torch.float32, (size,), dev)
    out = torch.empty((n_frames, size // 2), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.mlx_stft_mag(
            wav.data_ptr(), wav.shape[0], window.data_ptr(),
            twiddles(dev).data_ptr(), out.data_ptr(), n_frames, hop,
            float(scale), _build.stream(dev),
        )
    _build.check("stft_mag", err)
    stft_mag.launches += 1
    return out


stft_mag.launches = 0


# ----------------------------------------------------------------------
# B2: analysis DFT at arbitrary frame starts
# ----------------------------------------------------------------------


def analysis_plain(wav, starts, window, size: int):
    """(re, im) float32 (F, size // 2 + 1): natural-order rfft of
    ``window * wav[s : s + size]``, s = clip(starts, 0, n - 1), zeros past
    the end."""
    n = wav.shape[0]
    wavp = torch.nn.functional.pad(wav, (0, size))
    s = starts.to(torch.int64).clamp(0, max(n - 1, 0))
    idx = s[:, None] + torch.arange(size, device=wav.device)[None, :]
    spec = torch.fft.rfft(wavp[idx] * window[None, :])
    return spec.real.contiguous(), spec.imag.contiguous()


def analysis(wav, starts, window, size: int):
    """B2 (``csrc/pv_analysis.cu``: two frames per complex transform on
    ``fft2048_pair.cuh``); contract of :func:`analysis_plain`."""
    if wav.device.type == "cpu":
        return analysis_plain(wav, starts, window, size)
    dev = _build.cuda_device(wav)
    if size != FFT_N:
        raise _no_size(size)
    f = starts.shape[0]
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(starts, "starts", torch.int32, (f,), dev)
    _build.require(window, "window", torch.float32, (size,), dev)
    if wav.shape[0] == 0:
        raise ValueError("wav is empty")
    re = torch.empty((f, size // 2 + 1), dtype=torch.float32, device=dev)
    im = torch.empty_like(re)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.mlx_pv_analysis(
            wav.data_ptr(), wav.shape[0], starts.data_ptr(),
            window.data_ptr(), pair_twiddles(dev).data_ptr(), re.data_ptr(),
            im.data_ptr(), f, _build.stream(dev),
        )
    _build.check("analysis", err)
    analysis.launches += 1
    return re, im


analysis.launches = 0


# ----------------------------------------------------------------------
# B3: phase propagation + (identity locking) + synthesis + overlap-add
# ----------------------------------------------------------------------


def irfft_polar(mag, psi, size: int) -> torch.Tensor:
    """``irfft(mag * e^{i psi}, n=size)`` with the imaginary parts of DC and
    Nyquist dropped first, as a c2r inverse's contract says.  cuFFT leaves
    them undefined: on the H100 a batch of 2048 or more 2048-point
    transforms reads them (about -33 dB off a float64 inverse for random
    phases), so the twins drop them explicitly."""
    spec = torch.polar(mag, psi)
    spec[:, 0].imag = 0.0
    if size % 2 == 0 and spec.shape[1] == size // 2 + 1:
        spec[:, -1].imag = 0.0
    return torch.fft.irfft(spec, n=size)


def identity_lock(psi, phi, mag):
    """Laroche-Dolson identity phase locking in natural bin order: the plain
    twin of B3's ``lock=True`` (the TPU's ``_lock_psis``) and a copy of
    ``melonix_tpu/engine/phase_vocoder.py:identity_lock``.

    A bin is a peak when ``mag > 0``, strictly above bins k-1 and k-2 and at
    least bins k+1 and k+2 (edges compare against -1).  Each bin takes the
    region constant ``theta = psi - phi`` of its nearest peak (the lower one
    on a tie) and returns ``phi + theta_peak``; a frame with no peak returns
    ``phi + (psi - phi)``.  (F, n_bins) in, locked psi out; the nearest peaks
    come from a running max / min of peak indices along the bin axis.
    """
    n = mag.shape[-1]
    k = torch.arange(n, device=mag.device)
    edge = torch.full(mag.shape[:-1] + (2,), -1.0, dtype=mag.dtype,
                      device=mag.device)
    m = torch.cat([edge, mag, edge], dim=-1)  # m[..., k + 2] = mag[..., k]
    peak = ((mag > 0.0) & (mag > m[..., 1 : n + 1]) & (mag > m[..., :n])
            & (mag >= m[..., 3 : n + 3]) & (mag >= m[..., 4:]))
    theta = psi - phi
    far = 1 << 30
    pos_f = torch.cummax(torch.where(peak, k, -1), dim=-1).values
    pos_b = torch.cummin(torch.where(peak, k, far).flip(-1),
                         dim=-1).values.flip(-1)
    d_f = torch.where(pos_f >= 0, k - pos_f, far)
    d_b = torch.where(pos_b < far, pos_b - k, far)
    th_near = torch.where(d_f <= d_b, theta.gather(-1, pos_f.clamp_min(0)),
                          theta.gather(-1, pos_b.clamp_max(n - 1)))
    return phi + torch.where(torch.minimum(d_f, d_b) < far, th_near, theta)


def phase_increments(phi, da, m0: int, phi_prev, size: int, hop: int):
    """(F, n_bins) float32 ``hop * princarg(phi - prev - omega * d) / d``,
    d = max(da, 1e-3), prev the phase of the frame before (``phi_prev`` at
    frame 0); 0 on the global frame 0 (``m0 == 0``), which has no
    predecessor.  The terms whose running sum is B3's phase scan."""
    n_bins = phi.shape[1]
    step = float(np.float32(2.0 * np.pi / size))
    omega = torch.arange(n_bins, device=phi.device).to(torch.float32) * step
    d = da.clamp_min(1e-3)[:, None]
    prev = torch.cat([phi_prev[None, :], phi[:-1]], dim=0)
    dphi = torch.remainder(phi - prev - omega[None, :] * d + PI, TWO_PI) - PI
    incr = hop * dphi / d
    if m0 == 0:  # global frame 0: psi_0 = phi_0
        incr[0] = 0.0
    return incr


def _phase_terms(a, b, da, m0: int, phi0, resid_in, phi_prev, size: int,
                 hop: int, cart: bool):
    """(mag, phi, psi, resid, phi0_eff) of one chunk: the phase scan's
    formulas.  The running sum of the increments is taken in float64 and
    rounded once (the exact sum to float32 rounding: the value B3's blocked
    scan, the seq-parallel path and torch's CPU cumsum all form)."""
    f, n_bins = a.shape
    if cart:
        mag, phi = torch.sqrt(a * a + b * b), torch.atan2(b, a)
    else:
        mag, phi = a, b
    incr = phase_increments(phi, da, m0, phi_prev, size, hop)
    resid = (resid_in.double()[None, :]
             + torch.cumsum(incr.double(), dim=0)).float()
    k_idx = torch.arange(n_bins, device=a.device)
    step = float(np.float32(2.0 * np.pi / size))
    hm = ((m0 + torch.arange(f, device=a.device)) * hop) % size
    ramp = ((hm[:, None] * k_idx[None, :]) % size).to(torch.float32) * step
    phi0_eff = phi[0] if m0 == 0 else phi0
    psi = phi0_eff[None, :] + ramp + resid
    return mag, phi, psi, resid, phi0_eff


def synth_ola_phase_plain(a, b, da, window, m0: int, f_real: int, phi0,
                          resid_in, phi_prev, size: int, hop: int,
                          cart: bool = True, lock: bool = False):
    """One stretch chunk from its natural-order analysis spectrum: ``(a, b)``
    is ``(re, im)`` with ``cart`` (the default here; the TPU kernel's default
    is the other entry) and ``(mag, phi)`` without, as the formant path
    passes its warped magnitude (``pallas_pv.py:719-730``).

    Formulas of ``melonix_tpu/engine/phase_vocoder.py:_stretch_chunk_core``
    (natural path): princarg residual against omega * da, prefix sum over
    frames from ``resid_in`` (in float64, rounded once; the JAX package sums
    in float32), exact int mod-size ramp, with ``lock``
    :func:`identity_lock` on the unmasked magnitudes, live-frame mask,
    inverse rfft, window and overlap-add (``istft_device`` without
    normalisation).  Any frame size.  Returns ``(y, resid_last, phi_last,
    phi0_eff)``: the unnormalised OLA signal of length ``(F - 1) * hop +
    size`` and the carries of frame ``f_real - 1``.
    """
    f = a.shape[0]
    mag, phi, psi, resid, phi0_eff = _phase_terms(
        a, b, da, m0, phi0, resid_in, phi_prev, size, hop, cart)
    if lock:
        psi = identity_lock(psi, phi, mag)
    live = (torch.arange(f, device=a.device) < f_real)[:, None]
    mag_live = torch.where(live, mag, torch.zeros((), device=a.device))
    y = synth_ola_plain(mag_live, psi, window, size, hop)
    last = min(max(f_real - 1, 0), f - 1)
    return y, resid[last].clone(), phi[last].clone(), phi0_eff.clone()


def phase_scan_plain(a, b, da, m0: int, f_real: int, phi0, resid_in,
                     phi_prev, size: int, hop: int, cart: bool = True,
                     lock: bool = False):
    """B3's phase scan alone, as its launches leave it for the synthesis:
    ``(s_re, s_im, s_phi, resid_last, phi_last, phi0_eff)``, where without
    ``lock`` ``(s_re, s_im)`` is the live-masked half spectrum mag * e^{i
    psi} and ``s_phi`` is None, and with ``lock`` the three are the
    unmasked (mag, psi, phi)."""
    f = a.shape[0]
    mag, phi, psi, resid, phi0_eff = _phase_terms(
        a, b, da, m0, phi0, resid_in, phi_prev, size, hop, cart)
    last = min(max(f_real - 1, 0), f - 1)
    carries = (resid[last].clone(), phi[last].clone(), phi0_eff.clone())
    if lock:
        return (mag, psi, phi) + carries
    live = (torch.arange(f, device=a.device) < f_real)[:, None]
    mag_live = torch.where(live, mag, torch.zeros((), device=a.device))
    return (mag_live * torch.cos(psi), mag_live * torch.sin(psi),
            None) + carries


# B3's phase scan is blocked as the kernel's constants say
# (csrc/pv_synth_ola_phase.cu kScanRun, kScanRuns): a thread sums a run of
# SCAN_RUN frames, a tile of SCAN_TILE frames has one float64 total a bin.
SCAN_RUN = 16
SCAN_RUNS = 8
SCAN_TILE = SCAN_RUN * SCAN_RUNS


def _scan_operands(a, b, da, phi0, resid_in, phi_prev, size: int, hop: int,
                   cart: bool, lock: bool):
    """Check B3's operands on CUDA; allocate the scan's outputs and scratch:
    (s_re, s_im, s_phi or None, float64 tile scratch, resid_last, phi_last,
    phi0_eff)."""
    dev = _build.cuda_device(a)
    if size != FFT_N:
        raise _no_size(size)
    f = a.shape[0]
    nb = size // 2 + 1
    if f == 0 or hop <= 0:
        raise ValueError(f"{f} frames, hop {hop}")
    f32 = torch.float32
    names = ("re", "im") if cart else ("mag", "phi")
    for name, t, shape in ((names[0], a, (f, nb)), (names[1], b, (f, nb)),
                           ("da", da, (f,)), ("phi0", phi0, (nb,)),
                           ("resid_in", resid_in, (nb,)),
                           ("phi_prev", phi_prev, (nb,))):
        _build.require(t, name, f32, shape, dev)
    s_re = torch.empty((f, nb), dtype=f32, device=dev)
    s_im = torch.empty_like(s_re)
    s_phi = torch.empty_like(s_re) if lock else None
    n_tiles = -(-f // SCAN_TILE)
    scratch = torch.empty((2 * n_tiles * nb,), dtype=torch.float64, device=dev)
    carries = [torch.empty((nb,), dtype=f32, device=dev) for _ in range(3)]
    return (s_re, s_im, s_phi, scratch, *carries)


def phase_scan(a, b, da, m0: int, f_real: int, phi0, resid_in, phi_prev,
               size: int, hop: int, cart: bool = True, lock: bool = False):
    """B3's phase scan launches alone (``mlx_pv_phase_scan``), for timing
    and checking the scan apart from the synthesis; contract of
    :func:`phase_scan_plain`.  The render path runs the same launches inside
    :func:`synth_ola_phase`."""
    if a.device.type == "cpu":
        return phase_scan_plain(a, b, da, m0, f_real, phi0, resid_in,
                                phi_prev, size, hop, cart, lock)
    out = _scan_operands(a, b, da, phi0, resid_in, phi_prev, size, hop, cart,
                         lock)
    s_re, s_im, s_phi, scratch, resid_last, phi_last, phi0_eff = out
    dev = a.device
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.mlx_pv_phase_scan(
            *(t.data_ptr() for t in (a, b, da, phi0, resid_in, phi_prev,
                                     scratch, s_re, s_im)),
            s_phi.data_ptr() if lock else None,
            *(t.data_ptr() for t in (resid_last, phi_last, phi0_eff)),
            a.shape[0], int(m0), int(f_real), hop, int(bool(cart)),
            int(bool(lock)), _build.stream(dev),
        )
    _build.check("phase_scan", err)
    phase_scan.launches += 1
    return s_re, s_im, s_phi, resid_last, phi_last, phi0_eff


phase_scan.launches = 0


def synth_ola_phase(a, b, da, window, m0: int, f_real: int, phi0,
                    resid_in, phi_prev, size: int, hop: int, cart: bool = True,
                    lock: bool = False):
    """B3 (``csrc/pv_synth_ola_phase.cu``, five launches on one stream: the
    blocked phase scan's three, synthesis, overlap-add); contract of
    :func:`synth_ola_phase_plain`.  ``cart`` picks the phase scan's entry,
    ``(re, im)`` or ``(mag, phi)``, and ``lock`` adds identity locking to
    the synthesis launch; one wrapper call, one count, either way."""
    if a.device.type == "cpu":
        return synth_ola_phase_plain(a, b, da, window, m0, f_real, phi0,
                                     resid_in, phi_prev, size, hop, cart, lock)
    out = _scan_operands(a, b, da, phi0, resid_in, phi_prev, size, hop, cart,
                         lock)
    s_re, s_im, s_phi, scratch, resid_last, phi_last, phi0_eff = out
    dev = a.device
    f = a.shape[0]
    _build.require(window, "window", torch.float32, (size,), dev)
    frames = torch.empty((f, size), dtype=torch.float32, device=dev)  # scratch
    y = torch.empty(((f - 1) * hop + size,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.mlx_pv_synth_ola_phase(
            *(t.data_ptr() for t in (
                a, b, da, window, twiddles(dev), phi0, resid_in, phi_prev,
                scratch, s_re, s_im)),
            s_phi.data_ptr() if lock else None,
            *(t.data_ptr() for t in (
                frames, y, resid_last, phi_last, phi0_eff)),
            f, int(m0), int(f_real), hop, int(bool(cart)), int(bool(lock)),
            _build.stream(dev),
        )
    _build.check("synth_ola_phase", err)
    synth_ola_phase.launches += 1
    return y, resid_last, phi_last, phi0_eff


synth_ola_phase.launches = 0


# ----------------------------------------------------------------------
# B10: overlap-add synthesis from (mag, psi), the seq-parallel PV's
# ----------------------------------------------------------------------


def synth_ola_plain(mag, psi, window, size: int, hop: int) -> torch.Tensor:
    """The unnormalised windowed overlap-add of ``irfft(mag * e^{i psi})``
    over natural-order (F, size // 2 + 1) half spectra: length ``(F - 1) *
    hop + size`` (also the tail of :func:`synth_ola_phase_plain`).  The TPU
    kernel (``pallas_pv.synth_ola``) took the scrambled full spectrum and
    returned ``(F // 64 + 1) * 64 * hop`` samples, of which only this span
    was exact and the only one its caller read (sharded.py:737-738)."""
    f = mag.shape[0]
    t = irfft_polar(mag, psi, size) * window[None, :]
    out_len = (f - 1) * hop + size
    return torch.nn.functional.fold(
        t.T[None], output_size=(1, out_len), kernel_size=(1, size),
        stride=(1, hop),
    ).reshape(out_len)


def synth_ola(mag, psi, window, size: int, hop: int) -> torch.Tensor:
    """B10 (``csrc/pv_synth_ola.cu``, two launches on one stream); contract
    of :func:`synth_ola_plain`.  ``mag`` is already masked to the live
    frames; size 2048, any hop >= 1."""
    if mag.device.type == "cpu":
        return synth_ola_plain(mag, psi, window, size, hop)
    dev = _build.cuda_device(mag)
    if size != FFT_N:
        raise _no_size(size)
    f = mag.shape[0]
    if f == 0 or hop <= 0:
        raise ValueError(f"{f} frames, hop {hop}")
    nb = size // 2 + 1
    f32 = torch.float32
    _build.require(mag, "mag", f32, (f, nb), dev)
    _build.require(psi, "psi", f32, (f, nb), dev)
    _build.require(window, "window", f32, (size,), dev)
    frames = torch.empty((f, size), dtype=f32, device=dev)  # scratch
    y = torch.empty(((f - 1) * hop + size,), dtype=f32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.mlx_pv_synth_ola(
            mag.data_ptr(), psi.data_ptr(), window.data_ptr(),
            twiddles(dev).data_ptr(), frames.data_ptr(), y.data_ptr(), f, hop,
            _build.stream(dev),
        )
    _build.check("synth_ola", err)
    synth_ola.launches += 1
    return y


synth_ola.launches = 0

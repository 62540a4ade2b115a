"""Phase-vocoder DFT kernels B1-B3 and B10 and their plain PyTorch twins.

Counterpart of ``melonix_tpu/kernels/pallas_pv.py``.  The TPU kernels ran a
four-step bf16x3 MXU DFT in a scrambled bin order; the port's kernels keep
natural bin order and the 1025-bin half spectrum throughout.  B1
(``csrc/stft_mag.cu``) and B2 (``csrc/pv_analysis.cu``) transform two real
frames at once on the register-resident ``csrc/fft_pair.cuh`` (B1 through
``csrc/stft_mag_pair.cuh``, which B12 runs at its power-of-two sizes); the
synthesis of B3 (``csrc/pv_synth_ola_phase.cu``) and B10
(``csrc/pv_synth_ola.cu``) runs its inverse, two Hermitian half spectra a
complex transform (``csrc/pv_synth.cuh``, shared by both), with the
overlap-add carried in each CTA at the hops :func:`ola_route` names
"fused".  B3's phase scan is blocked over frames and sums in float64
(:func:`phase_scan`).

Each wrapper picks by its input's device and shape: a CUDA tensor at a
shape its kernel takes launches the kernel, anything else on a CUDA or CPU
tensor runs the ``*_plain`` twin on that tensor's device (as the JAX
package runs XLA where its kernels take no shape), and any other device
raises.  The twins are the CPU path and the reference the kernels are held
to on the card.  B1-B3 and B10 take 2048-point frames only: at other sizes
:func:`analysis` fetches the frames through ``kernels.frames`` (B9) and
runs ``torch.fft.rfft``, and :func:`synth_ola_phase` and :func:`synth_ola`
run their twins' natural-order formulas.  B1 and the standalone
:func:`phase_scan`, which no entry point calls at other sizes, raise there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from . import frames as kframes

FFT_N = 2048  # the only frame size the CUDA kernels take
# float32 constants of the JAX formulas, as Python floats holding f32 values
PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * np.pi))


def _no_size(size: int) -> NotImplementedError:
    return NotImplementedError(
        f"B1 and B3's phase scan take size {FFT_N}, got {size}: "
        "kernels.stft.stft_mags takes the |STFT| at any size, analysis and "
        "synth_ola_phase the phase vocoder's frames"
    )


def _cos_sin(ang: np.ndarray) -> np.ndarray:
    """(..., 2) float32 cos and sin of float64 angles, computed in float64."""
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


# The sizes csrc/fft_pair.cuh instantiates (Plan<N>): B1, B2 and the
# synthesis of B3 and B10 run 2048, B12 all of them.
PAIR_SIZES = (512, 1024, 2048, 4096, 8192)


@functools.cache
def pair_twiddles(size: int, device: torch.device) -> torch.Tensor:
    """(size + size // 16, 2) float32 cos/sin of ``fft_pair.cuh``'s pass
    twiddles at ``size`` = 256 R points, computed in float64: rows ``k2 *
    (size // 16) + b`` hold 2 pi b k2 / size (k2 < 16, b < size // 16), then
    rows ``size + q * R + c`` hold 2 pi c q / (16 R) (q < 16, c < R).  The
    kernel applies the transform's sign."""
    if size not in PAIR_SIZES:
        raise ValueError(f"no pair transform of {size} points")
    t, r = size // 16, size // 256
    k2, b = np.meshgrid(np.arange(16), np.arange(t), indexing="ij")
    q, c = np.meshgrid(np.arange(16), np.arange(r), indexing="ij")
    ang = np.concatenate([(2.0 * np.pi / size) * (b * k2).ravel(),
                          (2.0 * np.pi / (16 * r)) * (c * q).ravel()])
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


@_build.counted
def stft_mag(wav, window, size: int, hop: int, n_frames: int,
             scale: float = 1.0) -> torch.Tensor:
    """B1 (``csrc/stft_mag.cu``: two frames per complex transform on
    ``fft_pair.cuh``); contract of :func:`stft_mag_plain`."""
    if not _build.on_card(wav):
        return stft_mag_plain(wav, window, size, hop, n_frames, scale)
    if size != FFT_N:
        raise _no_size(size)
    if hop <= 0 or n_frames < 0:
        raise ValueError(f"hop {hop}, n_frames {n_frames}")
    dev = wav.device
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(window, "window", torch.float32, (size,), dev)
    out = torch.empty((n_frames, size // 2), dtype=torch.float32, device=dev)
    _build.launch(stft_mag, "stft_mag", "mlx_stft_mag", dev, wav,
                  wav.shape[0], window, pair_twiddles(FFT_N, dev), out,
                  n_frames, hop, float(scale))
    return out


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


@_build.counted
def analysis(wav, starts, window, size: int):
    """B2 (``csrc/pv_analysis.cu``: two frames per complex transform on
    ``fft_pair.cuh``); contract of :func:`analysis_plain`.  At sizes other
    than 2048 on any device: the frame fetch of
    ``kernels.frames.extract_frames`` (B9 where it takes the shape) and
    ``torch.fft.rfft``, as the JAX package runs them."""
    if size != FFT_N:
        frames = kframes.extract_frames(wav, starts, size)
        spec = torch.fft.rfft(frames * window[None, :])
        return spec.real, spec.imag
    if not _build.on_card(wav):
        return analysis_plain(wav, starts, window, size)
    dev = wav.device
    f = starts.shape[0]
    _build.require(wav, "wav", torch.float32, (wav.shape[0],), dev)
    _build.require(starts, "starts", torch.int32, (f,), dev)
    _build.require(window, "window", torch.float32, (size,), dev)
    if wav.shape[0] == 0:
        raise ValueError("wav is empty")
    re = torch.empty((f, size // 2 + 1), dtype=torch.float32, device=dev)
    im = torch.empty_like(re)
    _build.launch(analysis, "analysis", "mlx_pv_analysis", dev, wav,
                  wav.shape[0], starts, window, pair_twiddles(FFT_N, dev), re,
                  im, f)
    return re, im


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
    dev = a.device
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


@_build.counted
def phase_scan(a, b, da, m0: int, f_real: int, phi0, resid_in, phi_prev,
               size: int, hop: int, cart: bool = True, lock: bool = False):
    """B3's phase scan launches alone (``mlx_pv_phase_scan``), for timing
    and checking the scan apart from the synthesis; contract of
    :func:`phase_scan_plain`.  The render path runs the same launches inside
    :func:`synth_ola_phase`."""
    if not _build.on_card(a):
        return phase_scan_plain(a, b, da, m0, f_real, phi0, resid_in,
                                phi_prev, size, hop, cart, lock)
    if size != FFT_N:
        raise _no_size(size)
    out = _scan_operands(a, b, da, phi0, resid_in, phi_prev, size, hop, cart,
                         lock)
    s_re, s_im, s_phi, scratch, resid_last, phi_last, phi0_eff = out
    _build.launch(phase_scan, "phase_scan", "mlx_pv_phase_scan", a.device, a,
                  b, da, phi0, resid_in, phi_prev, scratch, s_re, s_im, s_phi,
                  resid_last, phi_last, phi0_eff, a.shape[0], int(m0),
                  int(f_real), hop, int(bool(cart)), int(bool(lock)))
    return s_re, s_im, s_phi, resid_last, phi_last, phi0_eff


# The overlap-add routes of B3's and B10's synthesis (csrc/pv_synth.cuh
# kOlaMinHop, kOlaMaxHop).  At hops with ceil(2048 / hop) <= 8 up to the
# frame size the overlap-add is carried in each CTA of the synthesis launch
# ("fused"); at the others the frame rows go through an (F, 2048) matrix
# to a second launch ("frames").  Both sum each sample in the same order
# and give the same bits.
OLA_MIN_HOP = FFT_N // 8
OLA_MAX_HOP = FFT_N
OLA_ROUTES = ("fused", "frames")


def ola_route(hop: int) -> str:
    """The overlap-add route of B3's and B10's synthesis at ``hop``: the
    hop alone picks it."""
    return "fused" if OLA_MIN_HOP <= hop <= OLA_MAX_HOP else "frames"


def _fused(hop: int, route: str | None) -> bool:
    """Whether a launch at ``hop`` takes the fused route: ``route`` None
    takes :func:`ola_route`'s; "frames" is taken at any hop, "fused" only
    where :func:`ola_route` names it."""
    want = ola_route(hop) if route is None else route
    if want not in OLA_ROUTES or (want == "fused"
                                  and ola_route(hop) != "fused"):
        raise ValueError(f"no overlap-add route {route!r} at hop {hop}")
    return want == "fused"


@_build.counted
def synth_ola_phase(a, b, da, window, m0: int, f_real: int, phi0,
                    resid_in, phi_prev, size: int, hop: int, cart: bool = True,
                    lock: bool = False, route: str | None = None):
    """B3 (``csrc/pv_synth_ola_phase.cu``: the blocked phase scan's three
    launches, then the pair synthesis with the overlap-add on the route
    :func:`ola_route` picks, or ``route`` where given, to compare the
    two); contract of :func:`synth_ola_phase_plain`.  ``cart`` picks the
    phase scan's entry, ``(re, im)`` or ``(mag, phi)``, and ``lock`` adds
    identity locking to the synthesis launch; one wrapper call, one count,
    either way.  At sizes other than 2048 on any device: the twin."""
    fused = _fused(hop, route)
    if size != FFT_N or not _build.on_card(a):
        return synth_ola_phase_plain(a, b, da, window, m0, f_real, phi0,
                                     resid_in, phi_prev, size, hop, cart, lock)
    out = _scan_operands(a, b, da, phi0, resid_in, phi_prev, size, hop, cart,
                         lock)
    s_re, s_im, s_phi, scratch, resid_last, phi_last, phi0_eff = out
    dev = a.device
    f = a.shape[0]
    _build.require(window, "window", torch.float32, (size,), dev)
    frames = None if fused else torch.empty((f, size), dtype=torch.float32,
                                            device=dev)  # scratch
    y = torch.empty(((f - 1) * hop + size,), dtype=torch.float32, device=dev)
    _build.launch(synth_ola_phase, "synth_ola_phase", "mlx_pv_synth_ola_phase",
                  dev, a, b, da, window, pair_twiddles(FFT_N, dev), phi0,
                  resid_in, phi_prev, scratch, s_re, s_im, s_phi, frames, y,
                  resid_last, phi_last, phi0_eff, f, int(m0), int(f_real),
                  hop, int(bool(cart)), int(bool(lock)), int(fused))
    return y, resid_last, phi_last, phi0_eff


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


@_build.counted
def synth_ola(mag, psi, window, size: int, hop: int,
              route: str | None = None) -> torch.Tensor:
    """B10 (``csrc/pv_synth_ola.cu``: B3's pair synthesis in its polar
    mode, the overlap-add on the route :func:`ola_route` picks, or
    ``route`` where given); contract of :func:`synth_ola_plain`.  ``mag``
    is already masked to the live frames; the kernel at size 2048, any hop
    >= 1, the twin at other sizes on any device."""
    fused = _fused(hop, route)
    if size != FFT_N or not _build.on_card(mag):
        return synth_ola_plain(mag, psi, window, size, hop)
    dev = mag.device
    f = mag.shape[0]
    if f == 0 or hop <= 0:
        raise ValueError(f"{f} frames, hop {hop}")
    nb = size // 2 + 1
    f32 = torch.float32
    _build.require(mag, "mag", f32, (f, nb), dev)
    _build.require(psi, "psi", f32, (f, nb), dev)
    _build.require(window, "window", f32, (size,), dev)
    frames = None if fused else torch.empty((f, size), dtype=f32,
                                            device=dev)  # scratch
    y = torch.empty(((f - 1) * hop + size,), dtype=f32, device=dev)
    _build.launch(synth_ola, "synth_ola", "mlx_pv_synth_ola", dev, mag, psi,
                  window, pair_twiddles(FFT_N, dev), frames, y, f, hop,
                  int(fused))
    return y

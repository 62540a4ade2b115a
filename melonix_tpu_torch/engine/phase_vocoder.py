"""Phase-vocoder pitch/time renderer (counterpart of
``melonix_tpu/engine/phase_vocoder.py``).

Formulation for time-VARYING pitch rate ``rho(t) = 2^(bend(t)/12)``:

1.  **Rate integral, closed form.**  ``p(t) = integral_0^t rho`` maps output
    time onto a "stretched" timeline; the bend is piecewise linear, so p is
    piecewise exponential with an analytic expression per knot segment.

2.  **PV time-stretch.**  Synthesis frames sit at ``m * hop`` on the
    stretched timeline; frame m analyses the source at
    ``A_m = time2Sample(p^-1(m * hop / sr))``, inverted per segment on the
    host in float64.  The phase propagation

        dphi   = princarg(phi_m - phi_{m-1} - omega_k * dA_m)
        psi_m  = psi_{m-1} + hop * (omega_k + dphi_m / dA_m)

    is a prefix sum over frames, followed by overlap-add.  Long tracks are
    stretched in chunks with exact phase carry (the prefix sum and OLA are
    both linear).

3.  **Variable-rate resample** back to the output timeline from int32 block
    bases + small float32 residuals (full precision at any track length).

The host half (segment table, frame plan, resample anchors) is the JAX
package's float64 NumPy code, copied, except that an anchor at a rate
segment's start takes that segment's constants by index
(:func:`_anchor_table`), where the JAX package searches on a time that can
round below the segment's start.  The device half runs kernels B2, B3
and B4 on a CUDA tensor and their plain twins on a CPU tensor, in natural
bin order with (size // 2 + 1)-bin phase state.  Formant preservation
(``preserve_formants``) warps the analysis magnitudes by a cepstral
envelope gain in PyTorch between B2 and B3, and enters B3 with (mag, phi)
instead of (re, im).  Identity phase locking (``phase_locking``,
:func:`identity_lock`) runs inside B3's synthesis launch.  Frame sizes other
than B2/B3's 2048 take the JAX package's unfused natural path: B9's frame
fetch, ``torch.fft.rfft``, B3's phase formulas in torch and the inverse
rfft + overlap-add.  A multichannel render (:func:`render_channels_pv`)
shares one plan across its channels.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, Config
from ..kernels import _build
from ..kernels import frames as kframes
from ..kernels import pv as kpv
from ..kernels import resample as kres
from ..kernels.pv import identity_lock  # noqa: F401  (its engine-level name)
from ..utils import tracing
from .maps import MapKnots
from .spectral import hann_window, resolve_device, track_on_device

LN2_12 = np.log(2.0) / 12.0

# ----------------------------------------------------------------------
# Host control plane (float64 NumPy, the JAX package's; see _anchor_table)
# ----------------------------------------------------------------------


def _segment_table(knots: MapKnots, t_end: float):
    """Per-segment (t0, b0, slope, P0) float64 rows covering [0, t_end].

    Segments: the knot intervals, the relaxation to 0 at duration()
    (app.cpp:1115-1119), and a constant-1-rate tail.  P0 is the exact
    cumulative rate integral at t0.
    """
    dur = knots.duration()
    ts = [float(t) for t in knots.times] + [max(dur, float(knots.times[-1])), t_end]
    bs = [float(b) for b in knots.bends] + [0.0, 0.0]
    # Deduplicate/enforce monotone (degenerate zero-length segments drop out)
    t0s, b0s, slopes, p0s = [], [], [], []
    P = 0.0
    for i in range(len(ts) - 1):
        t0, t1 = ts[i], ts[i + 1]
        if t1 <= t0:
            continue
        b0, b1 = bs[i], bs[i + 1]
        s = (b1 - b0) / (t1 - t0)
        t0s.append(t0)
        b0s.append(b0)
        slopes.append(s)
        p0s.append(P)
        r0, r1 = 2.0 ** (b0 / 12.0), 2.0 ** (b1 / 12.0)
        if abs(b1 - b0) < 1e-12:
            P += r0 * (t1 - t0)
        else:
            P += (t1 - t0) * (r1 - r0) / ((b1 - b0) * LN2_12)
    if not t0s:
        t0s, b0s, slopes, p0s = [0.0], [0.0], [0.0], [0.0]
    return (
        np.asarray(t0s), np.asarray(b0s), np.asarray(slopes), np.asarray(p0s), P
    )


def rate_integral_total(knots: MapKnots, t_end: float) -> float:
    """Exact ``integral_0^t_end 2^(bend(t)/12) dt`` (host sizing)."""
    return float(_segment_table(knots, t_end)[4])


def _invert_p(table, y: np.ndarray) -> np.ndarray:
    """t with p(t) = y, per-segment closed form (float64, vectorized)."""
    t0s, b0s, slopes, p0s, _ = table
    seg = np.clip(np.searchsorted(p0s, y, side="right") - 1, 0, len(t0s) - 1)
    t0, b0, s, P0 = t0s[seg], b0s[seg], slopes[seg], p0s[seg]
    r0 = 2.0 ** (b0 / 12.0)
    dy = y - P0
    flat = np.abs(s) < 1e-12
    with np.errstate(invalid="ignore", divide="ignore"):
        r_t = r0 + dy * s * LN2_12
        t_exp = t0 + (12.0 * np.log2(np.maximum(r_t, 1e-30)) - b0) / np.where(flat, 1.0, s)
    return np.where(flat, t0 + dy / r0, t_exp)


def _segment_at(t0s: np.ndarray, t_a: np.ndarray) -> np.ndarray:
    """Index of the segment that holds each time of ``t_a``: the last one
    starting at or before it."""
    return np.clip(np.searchsorted(t0s, t_a, side="right") - 1, 0,
                   len(t0s) - 1)


def _src_eval64(table, t_a: np.ndarray, sr: float,
                seg: np.ndarray | None = None) -> tuple[np.ndarray, ...]:
    """Float64 (src, rho, slope) of the stretched position curve at times t_a.

    src(t) = p(t)*sr - rho(t): the "exclusive" convention matching the
    per-sample cumulative-rate positions (sample j sits at p(t_j)*sr with
    t_j = (j+1)/sr, minus its own rate — so src(t_0) = 0 for unit rate).
    ``seg`` gives each time's segment; by default the one that holds it
    (:func:`_segment_at`).
    """
    t0s, b0s, slopes, p0s, _ = table
    if seg is None:
        seg = _segment_at(t0s, t_a)
    dt = t_a - t0s[seg]
    s = slopes[seg]
    r0 = 2.0 ** (b0s[seg] / 12.0)
    rho = 2.0 ** ((b0s[seg] + s * dt) / 12.0)
    flat = np.abs(s) < 1e-12
    with np.errstate(invalid="ignore", divide="ignore"):
        p = p0s[seg] + np.where(
            flat, r0 * dt, (rho - r0) / (np.where(flat, 1.0, s) * LN2_12)
        )
    return np.maximum(p * sr - rho, 0.0), rho, s


def _anchor_table(table, sr: float, n_out_pad: int, n_src: int):
    """Host control plane for the block-relative resample positions.

    Anchors = every resample block start UNION every rate-segment start, so
    no anchor-to-anchor span crosses a segment boundary and every span is
    <= BLK samples (exact int32 offsets, full f32 precision on device).

    An anchor at output sample j is evaluated at ``t_a = (j + 1) / sr``.  A
    segment starting at t0 anchors at ``j0 = ceil(t0 sr - 1 - 1e-9)``, the
    first sample whose time is not before t0, and takes that segment's
    constants by index: where ``t0 sr`` is a whole number, ``t_a`` can
    round one ulp below t0, and a search on it would take the previous
    segment's slope and let up to BLK samples drift.  Where several
    segments start within one sample, their anchor takes the last of them:
    each starts at or before ``t_a`` (to 1e-9 samples) and the next segment
    after it, so the last holds ``t_a``.  Block starts that begin no
    segment take the segment that holds ``t_a``.

    Returns (anc_j int32, src_rel f64, rho f64, slope f64, base int32,
    starts) with ``src_rel = src64(anchor) - base[block(anchor)]`` — small
    by construction (block span + SLACK), so its f32 image keeps
    ~1e-3-sample precision regardless of track length — and ``starts`` the
    number of anchors at segment starts.
    """
    blk = kres.BLK
    t0s = table[0]
    nb = n_out_pad // blk
    jb = np.arange(nb, dtype=np.int64) * blk
    seg_j0 = np.clip(
        np.ceil(t0s * sr - 1.0 - 1e-9), 0, n_out_pad - 1
    ).astype(np.int64)
    anc_j = np.union1d(jb, seg_j0)
    t_a = (anc_j + 1.0) / sr
    seg = _segment_at(t0s, t_a)
    # each segment-start anchor's own segment: the last segment at its sample
    order = np.argsort(seg_j0, kind="stable")
    j_sorted = seg_j0[order]
    last = np.append(j_sorted[1:] != j_sorted[:-1], True)
    seg[np.searchsorted(anc_j, j_sorted[last])] = order[last]
    src_a, rho_a, s_a = _src_eval64(table, t_a, sr, seg)
    # Block slab bases from the float64 block-start positions.
    base = kres.block_bases(src_a[np.searchsorted(anc_j, jb)], n_src)
    src_rel = src_a - base[np.minimum(anc_j // blk, nb - 1)].astype(np.float64)
    return (anc_j.astype(np.int32), src_rel, rho_a, s_a, base,
            int(np.count_nonzero(last)))


PV_CHUNK_FRAMES = 49152  # frames per stretch chunk


@dataclasses.dataclass(frozen=True)
class PVPlan:
    """Host control plane of one PV render (channel-independent).

    The plan depends only on the edit model (knots) and track length, never
    on the samples.  Same fields as the JAX package's ``PVPlan``.
    """

    size: int
    hop: int
    sr: int
    n_wav: int
    n_out: int
    n_out_pad: int
    n_frames: int
    stretch_len: int
    starts_m: np.ndarray  # int32 (n_frames,) exact frame starts
    da_m: np.ndarray  # float32 (n_frames,) frame advances
    rho_m: np.ndarray  # float64 (n_frames,) per-frame pitch rate
    anc_np: tuple  # host (anc_j, src_f32, rho_f32, s_f32) padded, + n_real
    base: np.ndarray  # int32 resample block bases
    rho_max: float  # knot-wise max rate

    @property
    def anc_args(self) -> tuple:
        """The padded anchor arrays as the JAX package's ``anc_args`` hands
        them to its sharded builders: (anc_j, src, rho, slope), the float
        values as their int32 bit patterns (NumPy)."""
        anc_j_p, src_f, r_f, s_f, _ = self.anc_np
        return (anc_j_p, src_f.view(np.int32), r_f.view(np.int32),
                s_f.view(np.int32))


def build_pv_plan(
    knots: MapKnots,
    n_wav: int,
    *,
    config: Config = DEFAULT_CONFIG,
    size: int | None = None,
    hop: int | None = None,
) -> PVPlan | None:
    """Float64 host control plane; None when the render is empty."""
    with tracing.span("pv.plan") as sp:
        plan = _pv_plan(knots, n_wav, size or config.stft_size,
                        hop or config.stft_hop)
        if plan is not None:
            sp.count(frames=plan.n_frames, anchors=plan.anc_np[4])
        return plan


def _pv_plan(knots: MapKnots, n_wav: int, size: int, hop: int):
    sr = knots.sample_rate
    n_out = int(knots.duration() * sr)
    if n_out <= 0 or n_wav < size:
        return None

    table = _segment_table(knots, n_out / sr)
    p_total = table[4]
    n_frames = int(np.ceil(p_total * sr / hop)) + 2
    n_frames = 64 * -(-n_frames // 64)
    n_out_pad = 8192 * -(-n_out // 8192)
    stretch_len = (n_frames - 1) * hop + size

    # Frame positions by analytic inversion, exact int32 frame starts,
    # float64-differenced frame advances.
    y_m = np.arange(n_frames, dtype=np.float64) * hop / sr
    t_m = _invert_p(table, np.minimum(y_m, p_total))
    with tracing.span("pv.plan.knots", frames=n_frames,
                      knots=len(knots.times)) as sp:
        a_m, bend_m, sorted_ = knots.time_to_sample_float_and_bend(t_m)
        sp.count(sorted=int(sorted_))
        rho_m = 2.0 ** (bend_m.astype(np.float64) / 12.0)
    starts_m = np.floor(np.clip(a_m, 0.0, n_wav - 1.0)).astype(np.int32)
    da_m = np.maximum(
        np.diff(a_m, prepend=a_m[0] - hop), 1e-3
    ).astype(np.float32)

    # Resample anchors: block-relative positions (see _anchor_table).
    with tracing.span("pv.plan.anchors") as sp:
        anc_j, src_rel64, rho_a, s_a, base, n_starts = _anchor_table(
            table, sr, n_out_pad, stretch_len
        )
        n_anc = 512 * -(-len(anc_j) // 512)  # same padding as the JAX plan
        pad_a = n_anc - len(anc_j)
        anc_j_p = np.pad(anc_j, (0, pad_a), constant_values=n_out_pad)
        anc_np = (
            anc_j_p,
            np.pad(np.asarray(src_rel64, np.float32), (0, pad_a),
                   mode="edge"),
            np.pad(np.asarray(rho_a, np.float32), (0, pad_a), mode="edge"),
            np.pad(np.asarray(s_a, np.float32), (0, pad_a), mode="edge"),
            len(anc_j),
        )
        sp.count(anchors=len(anc_j), starts=n_starts)
    rho_max = float(2.0 ** (max(np.max(table[1]), 0.0) / 12.0))
    return PVPlan(
        size=size, hop=hop, sr=sr, n_wav=n_wav, n_out=n_out,
        n_out_pad=n_out_pad, n_frames=n_frames, stretch_len=stretch_len,
        starts_m=starts_m, da_m=da_m, rho_m=rho_m,
        anc_np=anc_np, base=base, rho_max=rho_max,
    )


def pv_plan_from_numpy(fields: dict) -> PVPlan:
    """A port ``PVPlan`` from another plan's fields (e.g. the JAX package's
    ``PVPlan``), given as NumPy arrays and ints: lets a test feed both
    packages one identical plan."""
    anc = fields["anc_np"]
    return PVPlan(
        **{k: int(fields[k]) for k in ("size", "hop", "sr", "n_wav", "n_out",
                                       "n_out_pad", "n_frames", "stretch_len")},
        starts_m=np.asarray(fields["starts_m"], np.int32),
        da_m=np.asarray(fields["da_m"], np.float32),
        rho_m=np.asarray(fields["rho_m"], np.float64),
        anc_np=(
            np.asarray(anc[0], np.int32), np.asarray(anc[1], np.float32),
            np.asarray(anc[2], np.float32), np.asarray(anc[3], np.float32),
            int(anc[4]),
        ),
        base=np.asarray(fields["base"], np.int32),
        rho_max=float(fields["rho_max"]),
    )


def _chunk_arrays(plan: PVPlan, m0: int, ch: int):
    """Padded (starts, da, rho_f32, f_real) arrays for frames [m0, m0+ch)."""
    f_real = min(ch, plan.n_frames - m0)
    sl = slice(m0, m0 + f_real)
    pad_c = ch - f_real
    starts_c = np.pad(plan.starts_m[sl], (0, pad_c), mode="edge")
    da_c = np.pad(plan.da_m[sl], (0, pad_c), constant_values=float(plan.hop))
    rho_c = np.pad(plan.rho_m[sl].astype(np.float32), (0, pad_c), mode="edge")
    return starts_c, da_c, rho_c, f_real


# ----------------------------------------------------------------------
# Device half: B2 -> B3 per chunk, normalisation, B4
# ----------------------------------------------------------------------


def _stretch_chunk_core(wav, starts_c, da_c, window, m0: int, f_real: int,
                        phi0, resid_in, phi_prev, *, size: int, hop: int,
                        rho_c=None, formant: bool = False, n_ceps: int = 40,
                        lock: bool = False):
    """Unnormalized OLA contribution of frames [m0, m0+f_real) plus carried
    phase state ``(y_c, resid_last, phi_last, phi0_eff)``.

    The phase prefix sum carries across chunks (``resid_in``) and OLA
    overlaps add linearly, so chunking matches a one-shot stretch up to the
    float32 rounding of the running phase sum — no phase resets, no
    crossfades.  Frame starts are int32 (exact at any track length).  At
    2048-point frames analysis is B2 and the phase/lock/synthesis/OLA chain
    B3 on a CUDA tensor, their plain twins on a CPU tensor.  Other sizes take
    the JAX package's unfused natural path on any device: the frame fetch
    (B9 for the shapes ``kframes.supported`` takes, a gather otherwise),
    ``torch.fft.rfft``, and B3's formulas in torch (its plain twin, with an
    inverse rfft and overlap-add).  With ``formant`` the magnitudes are
    warped by :func:`_formant_gain` at the chunk's per-frame pitch rates
    ``rho_c`` and B3 takes ``(mag, phi)``.  With ``lock`` the synthesis
    phases are identity-locked (:func:`identity_lock`, peaks picked on the
    warped magnitudes): a per-frame transform, no carried state.
    """
    re, im = _analysis(wav, starts_c, window, size)
    synth = (kpv.synth_ola_phase if size == kpv.FFT_N
             else kpv.synth_ola_phase_plain)
    if not formant:
        return synth(re, im, da_c, window, m0, f_real, phi0, resid_in,
                     phi_prev, size, hop, cart=True, lock=lock)
    mag = torch.sqrt(re * re + im * im)
    phi = torch.atan2(im, re)
    del re, im
    with tracing.span("pv.formant", device=mag.device if mag.is_cuda else None,
                      frames=mag.shape[0], bins=size // 2 + 1, ceps=n_ceps):
        mag.mul_(_formant_gain(mag, rho_c, size, n_ceps))
    return synth(mag, phi, da_c, window, m0, f_real, phi0, resid_in, phi_prev,
                 size, hop, cart=False, lock=lock)


def _analysis(wav, starts, window, size: int):
    """Natural-order (re, im) of the windowed frames at ``starts``: B2 at
    2048 points, otherwise the frame fetch (B9 for the shapes
    ``kframes.supported`` takes, a gather otherwise) and ``torch.fft.rfft``;
    a CPU tensor runs the twins."""
    if size == kpv.FFT_N:
        return kpv.analysis(wav, starts, window, size)
    fetch = (kframes.extract_frames if kframes.supported(size, len(starts))
             else kframes.extract_frames_plain)
    spec = torch.fft.rfft(fetch(wav, starts, size) * window[None, :])
    return spec.real, spec.imag


def _formant_gain(mag, rho_m, size: int, n_ceps: int = 40):
    """Cepstral-envelope warp gain, natural bin order
    (``melonix_tpu/engine/phase_vocoder.py:_formant_gain``, scrambled=False).

    The envelope is ``n_ceps`` cosine coefficients of the log magnitude, a
    projection over the half spectrum with weights {1, 2, ..., 2, 1} / size
    (a matrix product accumulated in float64, so no TF32 setting of the
    caller's can reach it, rounded to float32); E at the rho-scaled bins is
    evaluated directly with a Chebyshev recurrence (T_q(cos t) = cos(q t)):
    gain_log[k] = sum_q 2 c_q (cos(q theta_k rho) - cos(q theta_k)),
    clipped to +-60 dB.
    """
    n_bins = size // 2 + 1
    dev = mag.device
    log_mag = torch.log(mag + 1e-8)
    qq = np.arange(1, n_ceps, dtype=np.float64)
    kk = np.arange(n_bins, dtype=np.float64)
    wk = np.full(n_bins, 2.0 / size)
    wk[0] = wk[-1] = 1.0 / size
    a_mat = torch.from_numpy(
        (wk[:, None] * np.cos(2.0 * np.pi * kk[:, None] * qq[None, :] / size))
        .astype(np.float32).astype(np.float64)).to(dev)  # c_q = L @ a_mat
    cep = torch.matmul(log_mag.double(), a_mat).to(torch.float32)
    theta = (2.0 * np.pi / size) * torch.arange(n_bins, dtype=torch.float32,
                                                device=dev)
    c1w = torch.cos(theta[None, :] * rho_m[:, None])
    c1p = torch.cos(theta)[None, :].expand_as(c1w)
    tw_prev, tw_cur = torch.ones_like(c1w), c1w
    tp_prev, tp_cur = torch.ones_like(c1w), c1p
    gain_log = 2.0 * cep[:, 0:1] * (c1w - c1p)
    for qi in range(2, n_ceps):
        tw_prev, tw_cur = tw_cur, 2.0 * c1w * tw_cur - tw_prev
        tp_prev, tp_cur = tp_cur, 2.0 * c1p * tp_cur - tp_prev
        gain_log = gain_log + 2.0 * cep[:, qi - 1 : qi] * (tw_cur - tp_cur)
    return torch.exp(gain_log.clamp(-6.9, 6.9))  # +-60 dB


def _ola_wsum(window, size: int, hop: int, n_frames: int, out_len: int):
    """Global window-square OLA normalizer (formulas of the JAX package).

    The interior is hop-periodic (every sample sees the same k = size/hop
    window taps), so the array is one tiled (hop,) pattern plus two
    size-long edge corrections, OVERWRITTEN with exact partial sums
    (subtracting missing taps cancels catastrophically where the Hann edge
    makes wsum ~1e-7).
    """
    k = size // hop
    w2 = window * window
    if size % hop != 0 or n_frames < k:
        # Non-whole overlap or fewer frames than one window span: direct sum.
        idx = (torch.arange(n_frames, device=window.device)[:, None] * hop
               + torch.arange(size, device=window.device)[None, :])
        keep = idx < out_len
        wsum = torch.zeros(out_len, dtype=torch.float32, device=window.device)
        wsum.index_put_((idx[keep],), w2.expand(n_frames, size)[keep],
                        accumulate=True)
        return wsum.clamp_min(1e-8)
    rows = w2.reshape(k, hop)
    pat = rows.sum(dim=0)  # (hop,)
    ws = pat.repeat(-(-out_len // hop))[:out_len]
    head = torch.cumsum(rows, dim=0).reshape(size)
    n_head = min(size, out_len)
    ws[:n_head] = head[:n_head]
    j0 = n_frames * hop
    if j0 < out_len:
        tail = (torch.cumsum(rows.flip(0), dim=0).flip(0) - rows).reshape(size)
        n_tail = min(size, out_len - j0)
        ws[j0 : j0 + n_tail] = tail[:n_tail]
    return ws.clamp_min(1e-8)


def _accum_at(y, y_c, off: int):
    """y[off : off+len(y_c)] += y_c, in place (saves the copy JAX's
    functional update makes)."""
    y[off : off + y_c.shape[0]].add_(y_c)
    return y


def _resample_pv_fused(plan: PVPlan, y):
    """Positions + lerp from a PVPlan: B4 on CUDA, its twin on CPU.  The
    seven operands go up in one packed upload."""
    anc_j_p, src_f, r_f, s_f, n_real = plan.anc_np
    nb = plan.n_out_pad // kres.BLK
    with tracing.span("pv.resample_operands"):
        a0, cnt, _kmax = kres.pv_anchor_blocks(anc_j_p[:n_real], nb)
        ops = kres.upload_pv_operands(plan.base, a0, cnt, anc_j_p[:n_real],
                                      src_f[:n_real], r_f[:n_real],
                                      s_f[:n_real], y.device)
    return kres.resample_pv(y, *ops, plan.sr, plan.n_out_pad)


def render_track_pv(
    wav,
    knots: MapKnots,
    *,
    config: Config = DEFAULT_CONFIG,
    size: int | None = None,
    hop: int | None = None,
    preserve_formants: bool = False,
    phase_locking: bool = False,
    device_out: bool = False,
    device=None,
):
    """Full-track phase-vocoder render honoring the marker edit model.

    Output spans the warped duration (``knots.duration()``).  ``wav`` is a
    NumPy array or a tensor; the render runs on ``device``, which defaults
    to the tensor's own device, or to ``"cuda"`` for NumPy input (there is
    no fallback: CUDA absent raises).  ``device_out`` returns the render as
    a tensor on that device instead of a NumPy array.  ``preserve_formants``
    keeps the spectral envelope (the timbre) in place while the pitch moves;
    ``phase_locking`` locks each bin's phase to its nearest spectral peak
    (Laroche-Dolson identity locking, the cure for phasiness).
    """
    with tracing.span("render_track_pv"):
        wav_dev = track_on_device(wav, device)
        dev = wav_dev.device
        n_wav = int(wav_dev.shape[0])
        plan = build_pv_plan(knots, n_wav, config=config, size=size, hop=hop)
        if plan is None:
            n_out = max(int(knots.duration() * knots.sample_rate), 0)
            zeros = torch.zeros(n_out, dtype=torch.float32, device=dev)
            return zeros if device_out else zeros.cpu().numpy()
        return _render_with_plan(wav_dev, plan, preserve_formants,
                                 phase_locking, device_out=device_out)


def _render_with_plan(wav_dev, plan: PVPlan, preserve_formants: bool = False,
                      phase_locking: bool = False, device_out: bool = False):
    """One channel through a PVPlan: chunked stretch, OLA normalisation,
    variable-rate resample, all on the device of ``wav_dev``."""
    dev = wav_dev.device
    size, hop = plan.size, plan.hop
    n_frames, stretch_len = plan.n_frames, plan.stretch_len
    (win,) = _build.upload(dev, hann_window(size))

    # Stretch in chunks with exact phase carry; OLA contributions add
    # linearly; normalize once globally.  Short tracks take one chunk.
    ch = min(PV_CHUNK_FRAMES, n_frames)
    n_state = size // 2 + 1
    one_chunk = n_frames <= ch
    y = None if one_chunk else torch.zeros(
        stretch_len + ch * hop + size, dtype=torch.float32, device=dev
    )
    resid = torch.zeros(n_state, dtype=torch.float32, device=dev)
    phi_prev = torch.zeros_like(resid)
    phi0 = torch.zeros_like(resid)
    for m0 in range(0, n_frames, ch):
        starts_c, da_c, rho_c, f_real = _chunk_arrays(plan, m0, ch)
        starts_d, da_d, *rho_d = _build.upload(
            dev, starts_c, da_c, *([rho_c] if preserve_formants else []))
        y_c, resid, phi_prev, phi0 = _stretch_chunk_core(
            wav_dev, starts_d, da_d, win, m0, f_real, phi0, resid, phi_prev,
            size=size, hop=hop, rho_c=rho_d[0] if rho_d else None,
            formant=preserve_formants, lock=phase_locking,
        )
        y = y_c if one_chunk else _accum_at(y, y_c, m0 * hop)

    # In-place normalisation of the stretch (no second stretch-sized buffer).
    with tracing.span("pv.normalise"):
        y = y[:stretch_len].div_(_ola_wsum(win, size, hop, n_frames,
                                           stretch_len))
    out = _resample_pv_fused(plan, y)[: plan.n_out]
    if device_out:
        return out
    with tracing.span("d2h", bytes=out.nbytes):
        return out.cpu().numpy()


def render_channels_pv(
    wav_ch,
    knots: MapKnots,
    *,
    config: Config = DEFAULT_CONFIG,
    size: int | None = None,
    hop: int | None = None,
    preserve_formants: bool = False,
    phase_locking: bool = False,
    mesh=None,
    device=None,
) -> np.ndarray:
    """(C, n) channels through ONE shared PV plan: the edit model is
    channel-independent, so the host plan is built once and each channel
    runs :func:`_render_with_plan` on ``device`` (default ``"cuda"``; no
    fallback), the JAX package's single-chip route
    (``phase_vocoder.py:1079-1089``).  There the channels go up in one copy
    and come down in one (:func:`_render_rows`), and the result is laid out
    as the input is: the transpose of a C-contiguous (n, C) take comes back
    as the transpose of a C-contiguous (n_out, C) array.  With ``mesh`` (a
    ``parallel.AudioMesh``) the channels, zero-padded to a multiple of its
    ``data`` axis, split over the data ranks, each rendering its own on the
    mesh's device, and are gathered.  Returns (C, n_out) float32."""
    with tracing.span("render_channels_pv"):
        wav_ch = np.asarray(wav_ch, np.float32)
        n_ch, n_wav = wav_ch.shape
        dev = resolve_device(mesh.device if mesh is not None
                             else "cuda" if device is None else device)
        plan = build_pv_plan(knots, n_wav, config=config, size=size, hop=hop)
        if plan is None:
            n_out = max(int(knots.duration() * knots.sample_rate), 0)
            return np.zeros((n_ch, n_out), np.float32)
        if mesh is None:
            return _render_rows(wav_ch, plan, preserve_formants,
                                phase_locking, dev)
        from ..parallel.sharded import _data_rows, _gather_data

        d = mesh.shape["data"]
        n_b = d * -(-n_ch // d)
        wav_ch = np.pad(wav_ch, ((0, n_b - n_ch), (0, 0)))
        mine = torch.stack([
            _render_with_plan(track_on_device(wav_ch[c], dev), plan,
                              preserve_formants, phase_locking,
                              device_out=True)
            for c in _data_rows(mesh, n_b)])
        out = torch.cat(_gather_data(mesh, mine))[:n_ch]
        with tracing.span("d2h", bytes=out.nbytes):
            return out.cpu().numpy()


def _render_rows(wav_ch: np.ndarray, plan: PVPlan, preserve_formants: bool,
                 phase_locking: bool, dev) -> np.ndarray:
    """(C, n) float32 channels through ``plan`` on ``dev`` with one copy
    each way.  The array goes up as it lies: where it is the transpose of a
    C-contiguous (n, C) take (``channels_last``), as that take.  Each
    channel, a row or a column of the upload, is made contiguous on the
    device, rendered, and written into one output laid out as the input,
    which comes down in one copy.  Other strides take one host copy first."""
    channels_last = (not wav_ch.flags.c_contiguous
                     and wav_ch.flags.f_contiguous)
    if channels_last:
        (take,) = _build.upload(dev, wav_ch.T)
        rows = take.T
    else:
        (rows,) = _build.upload(dev, np.ascontiguousarray(wav_ch))
    n_ch = rows.shape[0]
    out = torch.empty((plan.n_out, n_ch) if channels_last
                      else (n_ch, plan.n_out), dtype=torch.float32,
                      device=dev)
    out_rows = out.T if channels_last else out
    for c in range(n_ch):
        out_rows[c].copy_(_render_with_plan(
            rows[c].contiguous(), plan, preserve_formants, phase_locking,
            device_out=True))
    with tracing.span("d2h", bytes=out.nbytes):
        host = out.cpu().numpy()
    return host.T if channels_last else host

"""Streaming phase-vocoder renderer: the quality engine, live (counterpart of
``melonix_tpu/engine/pv_stream.py``).

The reference's defining loop is *hear the edit*: its audio callback pulls
from a backlog that ``process`` refills just ahead of the play cursor
(app.cpp:254-292), so a marker drag is audible within one buffer.  The
offline PV render (engine/phase_vocoder.py) decomposes into chunked
stretches with exact phase carry plus a per-block resample, both forward
only, which is a stream:

* the **stretch** advances chunk by chunk (B2 -> B3, or the unfused path
  at other frame sizes; formants and locking as asked) into a stretched
  buffer on the device, normalised by the window-square sum up to the last
  fully covered sample;
* each **read** resamples at positions computed once per stream
  (``kres.positions_rel_plain``): on the card with one launch of kernel
  B11 through the stream's ``kres.LerpReader``, which computes exactly the
  delivered samples straight into mapped host memory and waits; on the CPU
  through B11's twin (``kres.resample_lerp``) over the 2048-sample output
  blocks that cover the read;
* an **edit or seek restarts** the stream at the cursor: frames strictly
  before the splice's coverage window are skipped (every frame touching the
  first emitted sample IS rendered, so amplitude at the splice is exact)
  and phase re-anchors at the first rendered frame; the Player's declick
  ramp covers the phase seam.

A stream from t = 0 is the chunked offline render.  What the JAX stream
keeps only for XLA's compile cache and its tunnel (bucketed output,
quantum, download and buffer shapes; the fused advance-and-read program)
changes no value and is not ported; the read's output is the same at any
pull size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, Config
from ..kernels import resample as kres
from . import phase_vocoder as pv
from .maps import MapKnots
from .spectral import hann_window, track_on_device

STREAM_CHUNK_FRAMES = 2048  # ~24 s of stretched audio per stretch call


class PvStream:
    """Forward-only PV sample stream from ``start_sec``.

    ``read(n)`` returns the next n float32 samples (zeros past the warped
    end; ``exhausted`` flips once the real samples are all delivered).
    ``wav`` is a tensor (the stream runs on its device) or NumPy, uploaded
    to ``device`` (default ``"cuda"``; no fallback).  Immutable edit model:
    on a marker edit the owner drops the stream and builds a fresh one at
    the current cursor.
    """

    def __init__(
        self,
        wav,
        knots: MapKnots,
        *,
        config: Config = DEFAULT_CONFIG,
        size: int | None = None,
        hop: int | None = None,
        preserve_formants: bool = False,
        phase_locking: bool = False,
        start_sec: float = 0.0,
        chunk_frames: int = STREAM_CHUNK_FRAMES,
        device=None,
    ):
        self._blk = kres.BLK
        wav_dev = track_on_device(wav, device)
        self.sample_rate = int(knots.sample_rate)
        self.plan = pv.build_pv_plan(knots, int(wav_dev.shape[0]),
                                     config=config, size=size, hop=hop)
        self.preserve_formants = bool(preserve_formants)
        self.phase_locking = bool(phase_locking)
        if self.plan is None:
            self.n_out = 0
            self._j = 0
            return
        plan = self.plan
        self.n_out = plan.n_out
        sr, size_, hop_ = plan.sr, plan.size, plan.hop
        dev = wav_dev.device
        self._wav_dev = wav_dev

        # Host float64 position curve for the emit gate (which frames must
        # be stretched before an output sample is final).
        self._table = pv._segment_table(knots, plan.n_out / sr)
        j_start = int(np.clip(round(start_sec * sr), 0, max(plan.n_out - 1, 0)))
        self._j = j_start  # next output sample to deliver

        # Restart frame: every frame covering the first emitted stretched
        # position is included, so the splice has full OLA coverage
        # ((m_start-1)*hop + size <= src(j_start) by construction).
        src0 = self._src(j_start + 1.0)
        self._m_start = max(0, int((src0 - size_) // hop_) + 1) if j_start else 0
        self._frames_done = self._m_start  # global frames stretched so far

        self._ch = int(chunk_frames)
        self._win = torch.from_numpy(hann_window(size_)).to(dev)
        # The last chunk's OLA reach and the last finalised span both end
        # within one chunk span past the stretch.
        buf_len = plan.stretch_len + self._ch * hop_
        self._y = torch.zeros(buf_len, dtype=torch.float32, device=dev)
        self._y_norm = torch.zeros_like(self._y)
        # Window-square normaliser, 1.0 past stretch_len (the buffer is zero
        # there, so normalised pad reads stay zero).
        wsum = pv._ola_wsum(self._win, size_, hop_, plan.n_frames,
                            plan.stretch_len)
        self._wsum_pad = torch.cat([wsum, torch.ones(buf_len - plan.stretch_len,
                                                     device=dev)])
        self._fin = self._m_start * hop_  # stretched samples finalised
        n_state = size_ // 2 + 1
        self._resid = torch.zeros(n_state, dtype=torch.float32, device=dev)
        self._phi_prev = torch.zeros_like(self._resid)
        self._phi0 = torch.zeros_like(self._resid)

        # Per-sample block-relative read positions of the padded output,
        # once per stream; B11's slab bound from the plan's largest rate.
        anc_j, src_f, r_f, s_f, n_real = plan.anc_np
        anc = [self._put(a[:n_real]) for a in (anc_j, src_f, r_f, s_f)]
        self._pos = kres.positions_rel_plain(*anc, sr, plan.n_out_pad)
        self._base = self._put(plan.base)
        self._rows = kres.rows_for(max(plan.rho_max, float(plan.rho_m.max()),
                                       1.0))
        self._reader = (None if dev.type == "cpu" else
                        kres.LerpReader(self._y_norm, self._pos, self._base,
                                        self._rows))

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._wav_dev.device)

    def _src(self, t_samples: float) -> float:
        """Float64 stretched position of output time ``t_samples / sr``."""
        sr = self.plan.sr
        return float(pv._src_eval64(self._table, np.asarray([t_samples / sr]),
                                    sr)[0][0])

    # -- stretch advance ---------------------------------------------------

    def _pending_chunks(self, s_hi: float) -> list[int]:
        """Global start frames of the chunks that must be stretched before
        stretched samples < s_hi are finalised."""
        plan, hop = self.plan, self.plan.hop
        out, fd = [], self._frames_done
        while fd < plan.n_frames and fd * hop <= s_hi:
            out.append(fd)
            fd = min(fd + self._ch, plan.n_frames)
        return out

    def _normalize_span(self, off: int) -> None:
        span = slice(off, off + self._ch * self.plan.hop)
        torch.div(self._y[span], self._wsum_pad[span], out=self._y_norm[span])

    def _advance_one(self, m0_g: int) -> None:
        """One chunk: stretch, accumulate, finalise the span [fin, fin +
        ch*hop) it completes and, after the last chunk, the OLA overhang."""
        plan, hop = self.plan, self.plan.hop
        starts_c, da_c, rho_c, f_real = pv._chunk_arrays(plan, m0_g, self._ch)
        # The chunk's frame index restarts at the stream's first frame: phase
        # re-anchors there (psi = phi on the stream's frame 0).
        y_c, self._resid, self._phi_prev, self._phi0 = pv._stretch_chunk_core(
            self._wav_dev, self._put(starts_c), self._put(da_c), self._win,
            m0_g - self._m_start, f_real, self._phi0, self._resid,
            self._phi_prev, size=plan.size, hop=hop,
            rho_c=self._put(rho_c) if self.preserve_formants else None,
            formant=self.preserve_formants, lock=self.phase_locking,
        )
        pv._accum_at(self._y, y_c, m0_g * hop)
        self._normalize_span(self._fin)
        self._frames_done = min(m0_g + self._ch, plan.n_frames)
        self._fin += self._ch * hop
        if self._frames_done >= plan.n_frames:
            while self._fin < plan.stretch_len:
                self._normalize_span(self._fin)
                self._fin += self._ch * hop
            self._fin = plan.stretch_len

    def _advance_to(self, s_hi: float) -> None:
        """Stretch frames until stretched samples < s_hi are finalised."""
        for m0_g in self._pending_chunks(s_hi):
            self._advance_one(m0_g)

    # -- the pull API ------------------------------------------------------

    @property
    def exhausted(self) -> bool:
        return self.plan is None or self._j >= self.n_out

    def read(self, n: int) -> np.ndarray:
        """Next n samples (float32); zeros past the warped duration.  A read
        that delivers real samples stretches what they need and resamples
        them with one B11 launch."""
        out = np.zeros(n, np.float32)
        if self.exhausted:
            return out
        blk, j = self._blk, self._j
        hi = min(j + n, self.n_out)
        # Gate: the lerp touches floor(src) + 1; +2 covers the float32
        # positions' rounding.
        self._advance_to(self._src(float(hi)) + 2.0)
        if self._reader is not None:
            out[: hi - j] = self._reader.read(j, hi - j)
        else:
            b0, b1 = j // blk, -(-hi // blk)
            got = kres.resample_lerp(self._y_norm,
                                     self._pos[b0 * blk : b1 * blk],
                                     self._base[b0:b1], self._rows)
            out[: hi - j] = got[j - b0 * blk : hi - b0 * blk].numpy()
        self._j = hi
        return out

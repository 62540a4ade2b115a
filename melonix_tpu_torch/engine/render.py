"""Granular pitch/time renderer — the reference-parity export
(counterpart of ``melonix_tpu/engine/render.py``).

Reference semantics (app.cpp:294-345): ``process(cursor)`` renders one grain;
the playback rate is ``2^(pitchBend(cursor)/12)``; the grain is chosen by
``grains.lower_bound(time2Sample(cursor))`` — the time-warp map thereby
repeats/skips grains to time-stretch; the grain is linearly resampled by
stepping ``i * rate`` with the final in-grain sample interpolating toward the
*next* grain's first sample (the seam), where "next" is found by projecting
the output duration back through the warp map (app.cpp:312-329).  The offline
export (app.cpp:1194-1215) chains ``process`` from t=0 until the grain table
is exhausted, then emits ``preferred_grain_size`` zeros.

* **Plan (host, NumPy or native C++)** — the cursor chain is sequential but
  tiny (~N/1500 steps): ``build_render_plan`` emits per-step arrays (source
  start, length, f32 rate, output span, seam index), and ``seam_fixes`` the
  exact values where the upper lerp tap is not ``wav[src + 1]``.  Copied
  from the JAX package.
* **Execute (device)** — ``render`` runs B5 (per-step grain lerp) and B6
  (block compact) as one output-indexed kernel on a CUDA tensor, its plain
  twin on a CPU tensor, then scatters the seam fixes
  (``kernels/render.render_full``).
  ``render_device`` is an independent plain-torch formulation of the same
  output (one step lookup and two waveform gathers per output sample), used
  as a whole-path reference.  Rate arithmetic is float32 throughout and
  matches ``tests/oracle.py`` bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, Config
from ..kernels import render as krender
from .grains import GrainTable, _host_f32
from .maps import MapKnots
from .spectral import resolve_device

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """Per-step arrays describing a granular render; see module docstring."""

    grain_start: np.ndarray  # int32 (S,) source start of the chosen grain
    grain_len: np.ndarray  # int32 (S,)
    rate: np.ndarray  # float32 (S,) resampling rate 2^(bend/12)
    sz: np.ndarray  # int64 (S,) output samples produced by the step
    out_offset: np.ndarray  # int64 (S+1,) cumulative output offsets
    seam_src: np.ndarray  # int32 (S,) source index of the seam sample; -1 → 0.0
    tail_zeros: int  # zeros appended after the last grain (app.cpp:306-307)
    sample_rate: int

    @property
    def n_steps(self) -> int:
        return len(self.grain_start)

    @property
    def total_out(self) -> int:
        base = int(self.out_offset[-1]) if len(self.out_offset) else 0
        return base + self.tail_zeros

    @property
    def cursor_end(self) -> float:
        """Warped-time cursor after the last planned step."""
        return float(self.out_offset[-1]) / self.sample_rate


def _step_output_count(length: int, rate: F32) -> int:
    """Number of output samples for one grain: count of i >= 0 with
    floor(float32(i * rate)) < length (app.cpp:332-339, float arithmetic).

    O(1): the crossing index is within a couple of ulps of length/rate; probe
    the float32 product around it rather than materializing the ramp.
    """
    r = float(rate)
    n0 = int(length / r)  # first candidate near the crossing
    lo = max(0, n0 - 2)
    for i in range(lo, n0 + 8):
        if np.floor(F32(i) * rate) >= length:
            return i
    # Pathological rounding (not observed): fall back to a vector scan.
    i = np.arange(max(16, 2 * n0 + 16), dtype=np.float32)
    over = np.floor(i * F32(rate)) >= length
    return int(np.argmax(over)) if over.any() else len(i)


def build_render_plan(
    grains: GrainTable,
    knots: MapKnots,
    *,
    start_cursor: float = 0.0,
    min_out: int | None = None,
    config: Config = DEFAULT_CONFIG,
    backend: str = "auto",
) -> RenderPlan:
    """Walk the cursor chain (host control plane) and emit a RenderPlan.

    With ``min_out=None`` this mirrors ``App::exportWav``'s full-track loop
    (terminates when the grain table is exhausted, appending the trailing
    zeros the final ``process`` call pushes).  With ``min_out`` set it stops
    once at least that many output samples are planned (streaming/playback
    use, mirroring the backlog loop app.cpp:274-276) and appends no tail.

    ``backend="auto"`` uses the native C++ walker (built at first use;
    identical double/float arithmetic, ~500x faster than the Python loop),
    and NumPy only where no C++ compiler is found.
    """
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown plan backend {backend!r}")
    if backend in ("auto", "native"):
        from ..runtime import native

        lib = native.try_load()
        if lib is not None:
            gs, gl, rate, sz, seam, tail = native.build_plan(
                lib, grains, knots, start_cursor, min_out, config.preferred_grain_size
            )
            offs = np.zeros(len(sz) + 1, np.int64)
            np.cumsum(sz, out=offs[1:])
            return RenderPlan(
                grain_start=gs,
                grain_len=gl,
                rate=rate,
                sz=sz,
                out_offset=offs,
                seam_src=seam,
                tail_zeros=tail,
                sample_rate=knots.sample_rate,
            )
        if backend == "native":
            raise RuntimeError("native runtime: no C++ compiler found")
    starts = grains.starts
    sr = knots.sample_rate
    pgs = config.preferred_grain_size

    g_start: list[int] = []
    g_len: list[int] = []
    g_rate: list[F32] = []
    g_sz: list[int] = []
    g_seam: list[int] = []

    cursor = float(start_cursor)
    total = 0
    tail = 0
    n_grains = len(starts)
    while True:
        if min_out is not None and total >= min_out:
            break
        bend = knots.time_to_pitch_bend(cursor)  # float32 (app.cpp:296)
        rate = F32(2.0) ** F32(F32(bend) / F32(12.0))  # powf(2, bend/12)
        sample = knots.time_to_sample(cursor)
        gi = int(np.searchsorted(starts, sample, side="left"))
        if gi >= n_grains:
            tail = pgs  # app.cpp:303-309: 1500 zeros, then playback stops
            break
        length = int(grains.lengths[gi])
        sz = _step_output_count(length, rate)
        # Seam: project the output span through the warp map (app.cpp:312-329).
        s2 = knots.time_to_sample(cursor + 1.0 * sz / sr)
        g2 = int(np.searchsorted(starts, s2, side="left"))
        seam = int(starts[g2]) if g2 < n_grains else -1
        g_start.append(int(starts[gi]))
        g_len.append(length)
        g_rate.append(rate)
        g_sz.append(sz)
        g_seam.append(seam)
        total += sz
        cursor += 1.0 * sz / sr  # dt returned by process (app.cpp:344)

    offs = np.zeros(len(g_sz) + 1, np.int64)
    np.cumsum(np.asarray(g_sz, np.int64), out=offs[1:])
    return RenderPlan(
        grain_start=np.asarray(g_start, np.int32),
        grain_len=np.asarray(g_len, np.int32),
        rate=np.asarray(g_rate, np.float32),
        sz=np.asarray(g_sz, np.int64),
        out_offset=offs,
        seam_src=np.asarray(g_seam, np.int32),
        tail_zeros=tail,
        sample_rate=sr,
    )


# ----------------------------------------------------------------------
# Device execution
# ----------------------------------------------------------------------


def render_device(
    wav: torch.Tensor,
    offsets: torch.Tensor,  # int32 (S,) output start of each step (out_offset[:-1])
    gstart: torch.Tensor,  # int32 (S,)
    rate_bits: torch.Tensor,  # int32 (S,) float32 bit patterns of the rates
    n_valid_out: int,
    out_len: int,
    fix_idx: torch.Tensor,  # int32 (K,) seam-fix output positions (out_len = drop)
    fix_val: torch.Tensor,  # float32 (K,)
) -> torch.Tensor:
    """Two-gather granular render in plain torch, on ``wav``'s device.

    Every output sample finds its step (the last offset at or before it),
    evaluates ``x = f32(j - off) * rate`` and lerps between two waveform
    gathers at ``gstart + floor(x)`` and the sample after it (indices
    clamped to the track).  The next-grain seam (app.cpp:312-329) is
    ``wav[src + 1]`` everywhere except across time-warp jumps and at the
    track's end, which arrive as a precomputed host scatter (``fix_*``; see
    seam_fixes).  Independent of kernels B5/B6: the reference the kernel
    path is held to.
    """
    dev = wav.device
    n = wav.shape[0]
    j = torch.arange(out_len, dtype=torch.int64, device=dev)
    off64 = offsets.to(torch.int64)
    step = (torch.searchsorted(off64, j, right=True) - 1).clamp_min(0)
    r = rate_bits.view(torch.float32)[step]
    x = (j - off64[step]).to(torch.float32) * r  # f32(i) * rate
    idx = torch.floor(x)
    frac = x - idx
    src = gstart.to(torch.int64)[step] + idx.to(torch.int64)
    lo = wav[src.clamp(0, n - 1)]
    hi = wav[(src + 1).clamp(0, n - 1)]
    out = (1.0 - frac) * lo + frac * hi
    out = torch.where(j < n_valid_out, out, 0.0)
    keep = fix_idx < out_len
    out[fix_idx[keep].to(torch.int64)] = fix_val[keep]
    return out


def render_device_args(plan: RenderPlan, wav: np.ndarray, out_len: int):
    """Device operands for render_device (per-plan, tiny uploads)."""
    fix_idx, fix_val = seam_fixes(plan, wav, out_len)
    return (
        np.asarray(plan.out_offset[:-1], np.int32),
        np.asarray(plan.grain_start, np.int32),
        plan.rate.astype(np.float32).view(np.int32).copy(),
        np.int32(plan.out_offset[-1]) if len(plan.out_offset) else np.int32(0),
        out_len,
        fix_idx,
        fix_val,
    )


def seam_fixes(plan: RenderPlan, wav: np.ndarray, out_len: int):
    """Output positions + exact values where hi != wav[src+1] (warp jumps,
    track-end grains, seam_src == -1), padded to a static bucket."""
    wav = np.asarray(wav, np.float32)
    n = len(wav)
    gend = plan.grain_start.astype(np.int64) + plan.grain_len
    differs = (plan.seam_src != gend) | (gend >= n) | (plan.seam_src < 0)
    idx_list: list[np.ndarray] = []
    val_list: list[np.ndarray] = []
    for s in np.where(differs)[0]:
        length = int(plan.grain_len[s])
        rate = plan.rate[s]
        sz = int(plan.sz[s])
        i = np.arange(sz, dtype=np.float32)
        x = i * rate
        ii = np.floor(x)
        last = ii == length - 1  # samples whose hi is the seam
        if not last.any():
            continue
        frac = (x - ii)[last].astype(np.float32)
        lo = wav[int(plan.grain_start[s]) + length - 1]
        seam = plan.seam_src[s]
        hi = wav[seam] if 0 <= seam < n else np.float32(0.0)
        vals = (np.float32(1.0) - frac) * lo + frac * hi
        pos = int(plan.out_offset[s]) + np.where(last)[0]
        idx_list.append(pos.astype(np.int64))
        val_list.append(vals.astype(np.float32))
    if idx_list:
        idx = np.concatenate(idx_list)
        val = np.concatenate(val_list)
        keep = idx < out_len
        idx, val = idx[keep], val[keep]
    else:
        idx = np.zeros(0, np.int64)
        val = np.zeros(0, np.float32)
    k = max(256, 256 * -(-len(idx) // 256))
    out_idx = np.full(k, out_len, np.int64)  # out-of-range → dropped
    out_val = np.zeros(k, np.float32)
    out_idx[: len(idx)] = idx
    out_val[: len(val)] = val
    return out_idx.astype(np.int32), out_val


def _operands(wav, device):
    """(host float32 copy, device float32 tensor) of a track: a tensor
    renders on its own device (``device``, if given, must match); NumPy
    input on ``device``, default ``"cuda"`` (no fallback)."""
    if isinstance(wav, torch.Tensor):
        dev = resolve_device(wav.device if device is None else device)
        if wav.device != dev:
            raise ValueError(f"wav is on {wav.device}, render asked for {dev}")
        wav_dev = wav.to(torch.float32).contiguous()
        return _host_f32(wav_dev), wav_dev
    dev = resolve_device("cuda" if device is None else device)
    wav_np = _host_f32(wav)
    return wav_np, torch.from_numpy(wav_np).to(dev)


def render(
    wav,
    plan: RenderPlan,
    *,
    include_tail: bool = True,
    device=None,
    device_out: bool = False,
):
    """Execute a RenderPlan: B5 + B6 (one kernel) → seam fixes on CUDA, the
    plain twin on the CPU.  ``wav`` is a NumPy array or a tensor (see
    ``_operands`` for the device); returns a float32 NumPy array, or the
    tensor on the render device with ``device_out``.  An empty plan returns
    its ``total_out`` zeros without a launch."""
    wav_np, wav_dev = _operands(wav, device)
    dev = wav_dev.device
    n_grain_out = int(plan.out_offset[-1]) if len(plan.out_offset) else 0
    total = plan.total_out if include_tail else n_grain_out
    if total == 0 or plan.n_steps == 0:
        out = torch.zeros(total, dtype=torch.float32, device=dev)
    else:
        fix_idx, fix_val = seam_fixes(plan, wav_np, total)
        _gmax, szmax = krender._buckets(plan)
        out = krender.render_full(
            wav_dev, plan.grain_start, plan.rate, plan.sz,
            plan.out_offset[:-1], total, fix_idx, fix_val, szmax,
        )
    return out if device_out else out.cpu().numpy()


def render_track(
    wav,
    grains: GrainTable,
    knots: MapKnots,
    *,
    config: Config = DEFAULT_CONFIG,
    device=None,
    device_out: bool = False,
):
    """Full offline render: plan + device execution (export parity path)."""
    plan = build_render_plan(grains, knots, config=config)
    return render(wav, plan, device=device, device_out=device_out)

#!/usr/bin/env python3
"""Smoke run of melonix_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``melonix_tpu_torch/csrc`` and the
native host runtime from ``native/melonix_native.cpp``, holds each kernel
against its plain PyTorch twin on the card at the main paths' shapes, drives
the main paths once each on a 180 s, 44.1 kHz song with 12 markers (the
2048/512 |STFT| plus the phase-vocoder render; the granular export,
``render_track``; the Hann |STFT| pyramid at 2048/512 and 4096/1024 and
the waveform min/max pyramid; the spectrogram tile server's bursts and a
1280-column viewport; the pitch curve of the song; ``autotune`` with its
defaults, the formant-preserving phase vocoder, on a 180 s detuned melody;
the identity-locked render; renders at 4096/1024 (through B9) and 1000/250;
a locked stereo PV session; the streaming phase vocoder and the Player),
checks their output (the granular export bit for bit against its plain
references and ``tests/oracle.py``, the columns against a float64 oracle,
the tiles against an all-plain server, the pitch curve against the song's
closed-form f0, the autotuned melody against its snapped notes, locked
phasiness against classic, each stereo channel against its mono render,
the stream against the offline render, the first buffer after an edit
against the bent pitch, each path against its all-plain run), shows that
each run went through every kernel of its path, and times kernels, twins,
one-PyTorch-call yardsticks and paths beside each kernel's bound.  Any failed check raises: the script then exits
non-zero and prints no result.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It needs one GPU, ``nvcc``, a C++ compiler and ``nvidia-smi``, and imports
no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 44100
SECONDS = 180.0
REPS = 5  # timed repetitions after one warm-up; the median is reported
KERNEL_INNER = 10  # back-to-back calls per timed kernel repetition
# Published H100 SXM peaks at 700 W:
# device memory bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def make_song(sr: int, seconds: float) -> np.ndarray:
    """Two vibrato partials + noise (the JAX bench's song, bench.py:88-94)."""
    t = np.arange(int(sr * seconds)) / sr
    f = 220.0 * 2.0 ** (np.sin(2 * np.pi * 0.25 * t) * 0.5)
    x = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr)
    x += 0.2 * np.sin(2 * np.pi * 2.0 * np.cumsum(f) / sr)
    x += 0.01 * np.random.default_rng(0).standard_normal(len(t))
    return x.astype(np.float32)


def song_f0(t: np.ndarray) -> np.ndarray:
    """The fundamental of :func:`make_song` at times ``t`` (seconds)."""
    return 220.0 * 2.0 ** (np.sin(2 * np.pi * 0.25 * t) * 0.5)


def make_melody(sr: int, seconds: float, seed: int = 4):
    """A detuned melody for autotune: notes of 1.5 s (reference note scale,
    48 = 220 Hz) in steps of 2-5 semitones, each detuned by a seeded 20-45
    cents either way, three partials, noise 40 dB below the fundamental.
    Returns (samples, notes, cents)."""
    rng = np.random.default_rng(seed)
    n_notes = int(seconds / 1.5)
    notes = np.empty(n_notes, np.int64)
    notes[0] = 52
    for i in range(1, n_notes):
        step = int(rng.choice([-5, -4, -3, -2, 2, 3, 4, 5]))
        nxt = notes[i - 1] + step
        notes[i] = nxt if 43 <= nxt <= 62 else notes[i - 1] - step
    cents = rng.uniform(20.0, 45.0, n_notes) * rng.choice([-1.0, 1.0], n_notes)
    f = np.repeat(55.0 * 2.0 ** ((notes - 24 + cents / 100.0) / 12.0),
                  int(1.5 * sr))
    phase = 2 * np.pi * np.cumsum(f) / sr
    x = 0.5 * np.sin(phase) + 0.25 * np.sin(2 * phase) + 0.12 * np.sin(3 * phase)
    x += 0.005 * rng.standard_normal(len(x))
    return x.astype(np.float32), notes, cents


def curves_agree(got, want) -> tuple[float, float]:
    """(share of frames with equal voicing, share of the frames voiced in
    both whose notes agree within 0.01 semitone)."""
    both = got.voiced & want.voiced
    close = np.abs(got.note[both] - want.note[both]) < 0.01
    return (float(np.mean(got.voiced == want.voiced)),
            float(close.mean()) if both.any() else 1.0)


def bench_markers(mt, n: int):
    """The JAX bench's 12-marker edit (bench.py:786-790)."""
    return [
        mt.Marker(sample=int((i + 1) * n / 14), note=57.0,
                  d_time=0.01 * (1 if i % 2 == 0 else -1),
                  pitch_bend=float((-1) ** i) * (1 + i % 4))
        for i in range(12)
    ]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def snr_db(got, want) -> float:
    num = float(((got.double() - want.double()) ** 2).sum())
    den = float((want.double() ** 2).sum())
    return 10.0 * np.log10(max(num, 1e-300) / max(den, 1e-300))


def max_err(got, want) -> float:
    return float((got - want).abs().max())


def bit_equal(got, want) -> bool:
    """Two calls' outputs (tuples of tensors or None) are identical."""
    import torch

    return all((g is None and w is None) or torch.equal(g, w)
               for g, w in zip(got, want, strict=True))


def fft_flops(n_frames: int, size: int) -> float:
    """Operations of ``n_frames`` real ``size``-point FFTs (2.5 N log2 N)."""
    return n_frames * 2.5 * size * np.log2(size)


def covered_len(lo, hi, n: int) -> int:
    """Samples of [0, n) inside the union of the ranges [lo, hi): what a
    kernel that reads those windows must bring from device memory once."""
    lo = np.clip(np.asarray(lo, np.int64), 0, n)
    hi = np.clip(np.asarray(hi, np.int64), 0, n)
    keep = hi > lo
    order = np.argsort(lo[keep], kind="stable")
    lo, hi = lo[keep][order], hi[keep][order]
    if lo.size == 0:
        return 0
    prev_end = np.concatenate([[0], np.maximum.accumulate(hi)[:-1]])
    return int(np.maximum(hi - np.maximum(lo, prev_end), 0).sum())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what sets it): bytes over the memory
    rate against float32 operations over the float32 peak."""
    t_mem = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS_PER_S
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def column_f64(x: np.ndarray, start: int, end: int, size: int) -> np.ndarray:
    """Float64 reference column (spec.cpp:44-66, bench.py:121-133): the
    end-anchored window, exp(-2.5e-4 (start - i)) decay before start, zeros
    out of range, |DFT| of the first size // 2 bins over size."""
    idx = np.arange(end - size, end, dtype=np.int64)
    vals = x[np.clip(idx, 0, len(x) - 1)].astype(np.float64)
    dist = (start - idx).astype(np.float64)
    frame = np.where((idx >= 0) & (idx < len(x)),
                     vals * np.where(dist > 0, np.exp(-2.5e-4 * dist), 1.0), 0.0)
    return np.abs(np.fft.fft(frame)[: size // 2]) / size


def unpack_rgb(packed):
    """int32 0x00RRGGBB (B, bins) -> int32 (B, bins, 3) on the same device."""
    import torch

    return torch.stack([(packed >> 16) & 255, (packed >> 8) & 255,
                        packed & 255], dim=-1)


def values_of_rgb(tiles, lut: np.ndarray) -> np.ndarray:
    """RGB tiles (B, texels, 3) back to their uint8 value planes (the
    256-entry colormap LUT is one to one)."""
    code = lambda a: ((a[..., 0].astype(np.int64) << 16)  # noqa: E731
                      | (a[..., 1].astype(np.int64) << 8) | a[..., 2])
    lut_code = code(lut)
    check(len(np.unique(lut_code)) == 256, "colormap LUT is not one to one")
    order = np.argsort(lut_code)
    return order[np.searchsorted(lut_code[order], code(np.asarray(tiles)))]


def planes_close(got, want) -> tuple[float, int]:
    """(share of equal values, max difference) of two value planes."""
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    return float(np.mean(diff == 0)), int(diff.max())


def device_profile(fn):
    """One run of ``fn()`` under torch.profiler (CUPTI): (device ms by
    kernel or copy name, device busy ms, wall ms); busy is the union of the
    device intervals, so 1 - busy / wall is the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if cur_hi is None or lo > cur_hi:
            busy += 0.0 if cur_hi is None else cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += 0.0 if cur_hi is None else cur_hi - cur_lo
    return by_name, busy / 1e3, wall


def rms_env(got, want, size: int = 2048) -> tuple[float, float]:
    """(rms(got - want) / max|want|, max spectral-envelope error): the
    PV comparison convention of the JAX suite (test_pallas.py:511-523)."""
    import torch

    scale = float(want.abs().max())
    rms = float(torch.sqrt(((got - want) ** 2).mean())) / scale
    nseg = want.shape[0] // size
    f_g = torch.fft.rfft(got[: nseg * size].reshape(nseg, size)).abs()
    f_w = torch.fft.rfft(want[: nseg * size].reshape(nseg, size)).abs()
    return rms, float((f_g - f_w).abs().max() / f_w.max())


def cuda_ms(fn, reps: int = REPS, inner: int = 1) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs after a warm-up;
    each run makes ``inner`` calls back to back and counts their mean, so a
    short kernel's host-side wrapper overlaps the previous launch."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def host_ms(fn, reps: int = REPS) -> float:
    """Median wall time of ``fn()`` ending in a device synchronise, over
    ``reps`` runs after a warm-up (host work included)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


@contextlib.contextmanager
def plain_twins(kpv, kres, krender, kcols, kstft, kpitch, kframes):
    """Route the main paths through the plain twins (for the all-plain
    reference runs on the card); restores the kernels on exit."""
    saved = (kpv.stft_mag, kpv.analysis, kpv.synth_ola_phase,
             kres.resample_pv, krender.render_steps, krender.compact,
             kcols.spectrogram_columns_fused, kstft.stft_mag, kpitch.pitch_ac,
             kframes.extract_frames, kres.resample_lerp)
    kframes.extract_frames = kframes.extract_frames_plain
    kres.resample_lerp = kres.resample_lerp_plain
    kpitch.pitch_ac = kpitch.pitch_ac_plain
    kcols.spectrogram_columns_fused = kcols.spectrogram_columns_plain
    kstft.stft_mag = kstft.stft_mag_plain
    kpv.stft_mag = kpv.stft_mag_plain
    kpv.analysis = kpv.analysis_plain
    kpv.synth_ola_phase = kpv.synth_ola_phase_plain
    kres.resample_pv = (
        lambda y, base, a0, cnt, *rest: kres.resample_pv_plain(y, base, *rest)
    )
    krender.render_steps = krender.render_steps_plain
    krender.compact = (
        lambda vals, off, a0, cnt, out_len: krender.compact_plain(vals, off,
                                                                  out_len)
    )
    try:
        yield
    finally:
        (kpv.stft_mag, kpv.analysis, kpv.synth_ola_phase,
         kres.resample_pv, krender.render_steps, krender.compact,
         kcols.spectrogram_columns_fused, kstft.stft_mag,
         kpitch.pitch_ac, kframes.extract_frames, kres.resample_lerp) = saved


def load_oracle(root: str):
    """``tests/oracle.py`` (the literal transcription of the reference's
    render loop; NumPy only), loaded by path without the test package."""
    spec = importlib.util.spec_from_file_location(
        "oracle", os.path.join(root, "tests", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def granular_parity_max_err(mt, oracle, dev) -> float:
    """The JAX bench's parity fixture (bench.py:270-291): a 1.5 s, 8 kHz
    chirp with one marker through ``render_track`` on the card against
    ``oracle.export``; returns the max abs error (the lengths must agree)."""
    sr = 8000
    t = np.arange(int(sr * 1.5)) / sr
    x = (0.6 * np.sin(2 * np.pi * (180.0 + 120.0 * t) * t)).astype(np.float32)
    markers = [mt.Marker(sample=sr // 2, note=57.0, d_time=0.05,
                         pitch_bend=2.0)]
    table = mt.build_grain_table(x)
    knots = mt.MapKnots.from_markers(markers, sr, len(x))
    got = mt.render_track(x, table, knots, device=dev)
    tup = [(m.sample, m.note, m.d_time, m.pitch_bend) for m in markers]
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    want = oracle.export(x, grains, tup, sr)
    check(got.shape == want.shape, f"parity lengths {got.shape} {want.shape}")
    return float(np.max(np.abs(got - want)))


def pitch_err_cents(mt, dev, size=None, hop=None) -> float:
    """End-to-end PV pitch accuracy (bench.py:185-223): a 440 Hz tone through
    a +2-semitone plateau, dominant frequency of the output at the plateau
    from a 32768-pt reference column (computed on the host) with parabolic
    bin refinement, in cents against 440 * 2^(2/12).  ``size``/``hop``: the
    PV frame (default the config's 2048/512)."""
    n = 5 * SR
    t = np.arange(n) / SR
    tone = (0.5 * np.sin(2.0 * np.pi * 440.0 * t)).astype(np.float32)
    knots = mt.MapKnots.from_markers(
        [mt.Marker(n // 3, 57.0, 0.0, 2.0),
         mt.Marker(2 * n // 3, 57.0, 0.0, 2.0)], SR, n)
    out = mt.render_track_pv(tone, knots, device=dev, size=size, hop=hop)
    size = 32768
    end = n // 2
    col = column_f64(out, end - int(0.05 * SR), end, size)
    k = 1 + int(np.argmax(col[1 : size // 2 - 1]))
    ym1, y0, yp1 = col[k - 1], col[k], col[k + 1]
    denom = ym1 - 2 * y0 + yp1
    dk = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-12 else 0.0
    f_got = (k + float(np.clip(dk, -0.5, 0.5))) * SR / size
    return float(1200.0 * np.log2(f_got / (440.0 * 2.0 ** (2.0 / 12.0))))


def mod_index(y: np.ndarray, sr: int) -> float:
    """Amplitude-modulation index of the four strongest partials over the
    steady plateau [1.2 s, 2.8 s) (bench.py:247-262): vertical phase
    incoherence shows as beating of the window's mainlobe bins."""
    size, hop = 2048, 512
    seg = y[int(1.2 * sr): int(2.8 * sr)]
    n_f = (len(seg) - size) // hop
    fr = np.stack([seg[i * hop: i * hop + size] for i in range(n_f)])
    mags = np.abs(np.fft.rfft(fr * np.hanning(size)))
    mean = mags.mean(0)
    ks: list[int] = []
    for kk in np.argsort(mean)[::-1]:
        if all(abs(int(kk) - j) > 4 for j in ks):
            ks.append(int(kk))
        if len(ks) == 4:
            break
    return float(np.mean([mags[:, kk].std() / mags[:, kk].mean() for kk in ks]))


def pv_phasiness(mt, dev) -> tuple[float, float]:
    """bench.py:226-267: two inharmonic tones through a +3 st plateau at
    44.1 kHz, rendered classic and locked on ``dev``; returns their
    modulation indices (classic, locked)."""
    sr = 44100
    n = 4 * sr
    t = np.arange(n) / sr
    x = (0.4 * np.sin(2 * np.pi * 311.1 * t)
         + 0.4 * np.sin(2 * np.pi * 554.4 * t)).astype(np.float32)
    knots = mt.MapKnots.from_markers(
        [mt.Marker(n // 4, 57.0, 0.0, 3.0), mt.Marker(3 * n // 4, 57.0, 0.0, 3.0)],
        sr, n)
    classic = mt.render_track_pv(x, knots, device=dev)
    locked = mt.render_track_pv(x, knots, device=dev, phase_locking=True)
    return mod_index(classic, sr), mod_index(locked, sr)


def dominant_hz(buf: np.ndarray, sr: int, lo: float, hi: float) -> float:
    """The strongest frequency of ``buf`` in [lo, hi] Hz: Hann window,
    zero-padded 65536-point |FFT|, parabolic refinement."""
    size = 65536
    spec = np.abs(np.fft.rfft(buf * np.hanning(len(buf)), size))
    k0, k1 = int(lo * size / sr), int(hi * size / sr)
    k = k0 + int(np.argmax(spec[k0:k1]))
    ym1, y0, yp1 = spec[k - 1], spec[k], spec[k + 1]
    denom = ym1 - 2 * y0 + yp1
    dk = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-12 else 0.0
    return (k + float(np.clip(dk, -0.5, 0.5))) * sr / size


def live_pv_sustained(mt, seconds: float = 15.0) -> dict:
    """bench.py:574-622: continuous 1024-sample pulls through the Player on
    the PV engine (on the card) against the audio clock, after one
    prebuffering pull; a pull underruns when the wall clock has passed the
    audio it has delivered."""
    sr = 44100
    n = int(sr * (seconds + 6.0))
    t = np.arange(n) / sr
    x = (0.5 * np.sin(2 * np.pi * 220.0 * t)
         + 0.2 * np.sin(2 * np.pi * 331.0 * t)).astype(np.float32)
    knots = mt.MapKnots.from_markers(
        [mt.Marker(n // 3, 57.0, 0.0, 3.0), mt.Marker(2 * n // 3, 57.0, 0.0, -2.0)],
        sr, n)
    p = mt.Player(x, mt.build_grain_table(x), knots, engine="pv")
    p.is_playing = True
    buf = 1024
    first = p.callback(buf)
    check(np.abs(first).max() > 1e-4, "live PV stream started silent")
    pulls = int(seconds * sr / buf)
    t0 = time.perf_counter()
    audio, under, worst = 0.0, 0, 0.0
    for _ in range(pulls):
        p.callback(buf)
        audio += buf / sr
        behind = (time.perf_counter() - t0) - audio
        worst = max(worst, behind)
        under += behind > 0.0
    wall = time.perf_counter() - t0
    return {"live_pv_underruns": under, "live_pv_x_realtime": audio / wall,
            "live_pv_worst_lag_ms": 1e3 * worst}


def rms_rel_env(got: np.ndarray, want: np.ndarray, sr: int) -> tuple:
    """(rms(got - want) / rms(want), worst quarter-second spectral-envelope
    error): the seq-parallel PV bars of the JAX suite
    (test_parallel.py:219-231; bars 2e-3 and 0.02)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = float(np.sqrt(np.mean((got - want) ** 2))
                / (np.sqrt(np.mean(want ** 2)) + 1e-12))
    win_n, worst = sr // 4, 0.0
    for w0 in range(0, len(want) - win_n, win_n):
        a = np.abs(np.fft.rfft(want[w0 : w0 + win_n] * np.hanning(win_n)))
        b = np.abs(np.fft.rfft(got[w0 : w0 + win_n] * np.hanning(win_n)))
        worst = max(worst, float(np.sqrt(np.sum((a - b) ** 2))
                                 / (np.sqrt(np.sum(a ** 2)) + 1e-12)))
    return rms, worst


def pv_sum_order_render(mt, x: np.ndarray, markers, dev,
                        split: int | None = None) -> np.ndarray:
    """The PV render of ``x`` by the seq-parallel path's formulas in torch
    on ``dev`` (the path's own analysis, B2 on CUDA, whose float32 rounding
    carried through thousands of frames of phase sums would otherwise be
    read as the sum's; B10's twin, the masked normaliser, the path's
    positions and lerp), its phase sum formed in a chosen order:
    ``split=None`` sums the increments exactly (float64, rounded once to
    float32), the reference the sharded sum is held to; ``split=s`` sums
    frames [0, s) and [s, F) each from zero in float32 and adds the first
    part's total to the second (the JAX package's two-rank order);
    ``split=0`` is one serial float32 sum (the order B3's scan had before
    it was blocked and summed in float64)."""
    import torch

    from melonix_tpu_torch.engine import phase_vocoder as pv
    from melonix_tpu_torch.engine.spectral import hann_window
    from melonix_tpu_torch.kernels import pv as kpv
    from melonix_tpu_torch.kernels import resample as kres
    from melonix_tpu_torch.parallel import sharded

    plan = pv.build_pv_plan(mt.MapKnots.from_markers(markers, SR, len(x)),
                            len(x))
    kw, (starts, da, _rho, f_real, anc_j, src, rr, ss, base) = \
        sharded.seq_pv_args(plan, 1)
    size, hop, n_f, fr = kw["size"], kw["hop"], kw["n_frames"], int(f_real)
    mesh = mt.make_audio_mesh(1, device=dev)
    f32 = torch.float32
    win = sharded._on(mesh, hann_window(size), f32)
    re, im = kpv.analysis(sharded._on(mesh, x, f32),
                          sharded._on(mesh, starts, torch.int32), win, size)
    mag, phi = torch.sqrt(re * re + im * im), torch.atan2(im, re)
    del re, im
    k = torch.arange(size // 2 + 1, device=mag.device)
    step = float(np.float32(2.0 * np.pi / size))
    d = sharded._on(mesh, da, f32).clamp_min(1e-3)[:, None]
    prev = torch.cat([phi[:1], phi[:-1]])  # frame 0's increment is zeroed
    dphi = torch.remainder(phi - prev - (k.to(f32) * step)[None, :] * d
                           + kpv.PI, kpv.TWO_PI) - kpv.PI
    incr = (hop * dphi / d).cpu().numpy()
    incr[0] = 0.0
    # NumPy's cumsum adds in sequence at the dtype it is given (torch's, on
    # the CPU, accumulates float32 in float64)
    if split is None:
        resid = np.cumsum(incr, axis=0, dtype=np.float64).astype(np.float32)
    else:
        resid = np.cumsum(incr, axis=0, dtype=np.float32)
        if split:
            resid[split:] = resid[split - 1] + np.cumsum(
                incr[split:], axis=0, dtype=np.float32)
    resid = torch.from_numpy(resid).to(mag.device)
    m = torch.arange(n_f, device=mag.device)
    ramp = ((((m * hop) % size)[:, None] * k[None, :]) % size).to(f32)
    psi = phi[0][None, :] + ramp * step + resid
    mag = torch.where((m < fr)[:, None], mag, torch.zeros((), device=mag.device))
    span = n_f * hop
    y = (kpv.synth_ola_plain(mag, psi, win, size, hop)[:span]
         / sharded._wsum_masked(win, fr, size, hop, n_f, span))
    anc = sharded._anchors(mesh, anc_j, src, rr, ss)
    pos = kres.positions_rel_plain(*anc, plan.sr, kw["n_out_pad"], j0=0)
    out = kres.lerp_resample_rel(y, pos, sharded._on(mesh, base, torch.int32),
                                 span)
    return out[: plan.n_out].cpu().numpy()


def snr_np(got, want) -> float:
    err = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float(10 * np.log10((np.mean(err ** 2) + 1e-30)
                               / (np.mean(np.asarray(want, np.float64) ** 2)
                                  + 1e-30)))


def batch_jobs(mt, x: np.ndarray):
    """Four jobs of the serving path at the song's scale: the song with the
    bench edit, reversed with the edit shifted, its first 120 s with the
    first six markers, and 0.8 x the song with no edit."""
    n = len(x)
    ms = bench_markers(mt, n)
    shifted = [mt.Marker(sample=m.sample + SR // 3, note=m.note,
                         d_time=m.d_time, pitch_bend=-m.pitch_bend)
               for m in ms]
    tracks = [x, np.ascontiguousarray(x[::-1]), x[: 120 * SR].copy(),
              (0.8 * x).astype(np.float32)]
    return tracks, [ms, shifted, ms[:6], []]


def rank_main(argv) -> int:
    """One rank of phase 20's gloo group on the card (the parent runs
    ``chip_smoke.py --rank R --world W --port P --out DIR`` per rank): the
    sequence-parallel PV of the song on a (1, W) mesh, the batch of four
    jobs and a stereo session on a (W, 1) mesh, each rank computing on
    cuda:0; writes its numbers and rank 0's reference checks to DIR."""
    import argparse

    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.kernels import pv as kpv
    from melonix_tpu_torch.kernels import resample as kres
    from melonix_tpu_torch.utils import Timer, registry

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a.port}",
                            world_size=a.world, rank=a.rank)
    seq_mesh = mt.make_audio_mesh(a.world, data=1)
    data_mesh = mt.make_audio_mesh(a.world, data=a.world)
    x = make_song(SR, SECONDS)
    markers = bench_markers(mt, len(x))
    gather = registry("parallel.gather", Timer)
    sent = registry("parallel.gather_bytes")
    counters = (kpv.analysis, kpv.synth_ola, kpv.synth_ola_phase,
                kres.resample_pv)
    res = {"rank": a.rank, "kind": torch.cuda.get_device_name(0)}

    def run(label, fn):
        """fn() once counted and timed (after all ranks arrive), with its
        kernel launches and all-gathers, then once more under the profiler
        (device busy and idle share)."""
        for c in counters:
            c.launches = 0
        g_s, g_n, g_b = gather.total, gather.count, sent.value
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res[label] = {
            "wall_ms": 1e3 * (time.perf_counter() - t0),
            "gather_ms": 1e3 * (gather.total - g_s),
            "gathers": gather.count - g_n, "gather_bytes": sent.value - g_b,
            "launches": {c.__name__: c.launches for c in counters}}
        dist.barrier()
        names, busy, wall = device_profile(fn)
        top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
        res[label]["profile"] = {"busy_ms": busy, "wall_ms": wall,
                                 "top": [[k[:48], v] for k, v in top]}
        return out

    def seq_pv():
        return mt.render_session(x, markers, SR, engine="pv", mesh=seq_mesh)

    # warm-up (cuFFT plans, the caching allocator), keeping B10's operands:
    # this rank's live magnitudes and synthesis phases, held below against
    # B10's twin on the same inputs
    b10, seen = kpv.synth_ola, []

    def b10_seen(mag, psi, window, size, hop):
        y = b10(mag, psi, window, size, hop)
        seen.append((mag, psi, window, size, hop, y))
        return y

    b10_seen.launches = 0  # the wrapper counts on the module's name
    kpv.synth_ola = b10_seen
    try:
        seq_pv()
    finally:
        kpv.synth_ola = b10
    (mag, psi, window, size, hop, y), = seen
    want = kpv.synth_ola_plain(mag, psi, window, size, hop)
    err = (y.double() - want.double()).square().sum()
    res["b10_vs_twin"] = {
        "frames": int(mag.shape[0]),
        "live": int((mag.abs().amax(dim=1) > 0).sum()),
        "max_abs_psi": float(psi.abs().max()),
        "same_shape": y.shape == want.shape,
        "snr_db": float(10.0 * torch.log10(
            err.clamp_min(1e-300) / want.double().square().sum())),
        "max_abs_err": float((y - want).abs().max())}
    del seen, mag, psi, y, want
    out = run("seq_pv", seq_pv)
    np.save(os.path.join(a.out, f"seq_pv_rank{a.rank}.npy"), out)

    tracks, ms_l = batch_jobs(mt, x)
    for engine in ("granular", "pv"):
        outs = run(f"batch_{engine}", lambda: mt.render_batch(
            tracks, ms_l, SR, engine=engine, mesh=data_mesh))
        if a.rank == 0:
            errs = []
            for t, ms, o in zip(tracks, ms_l, outs):
                want = mt.render_session(t, ms, SR, engine=engine, mesh=None)
                same_len = o.shape == want.shape
                if engine == "granular":
                    errs.append([same_len, float(np.abs(o - want).max()),
                                 bool(np.array_equal(o == 0.0, want == 0.0))])
                else:
                    errs.append([same_len, snr_np(o, want)])
            res[f"batch_{engine}"]["vs_render_session"] = errs
    st = np.ascontiguousarray(np.stack([x, 0.8 * x[::-1]], axis=1),
                              dtype=np.float32)
    for engine in ("granular", "pv"):
        got = run(f"stereo_{engine}", lambda: mt.render_session(
            st, markers, SR, engine=engine, mesh=data_mesh))
        if a.rank == 0:
            want = mt.render_session(st, markers, SR, engine=engine,
                                     mesh=None)
            res[f"stereo_{engine}"]["vs_no_mesh"] = [
                got.shape == want.shape, float(np.abs(got - want).max()),
                bool(np.array_equal(got == 0.0, want == 0.0))]
    with open(os.path.join(a.out, f"rank{a.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.engine import phase_vocoder as pv
    from melonix_tpu_torch.engine import render as grender
    from melonix_tpu_torch.engine.spectral import (hann_window, num_frames,
                                                   view_column_ranges)
    from melonix_tpu_torch.kernels import _build
    from melonix_tpu_torch.engine import autotune as eat
    from melonix_tpu_torch.kernels import columns as kcols
    from melonix_tpu_torch.kernels import frames as kframes
    from melonix_tpu_torch.kernels import pitch as kpitch
    from melonix_tpu_torch.kernels import pv as kpv
    from melonix_tpu_torch.kernels import render as krender
    from melonix_tpu_torch.kernels import resample as kres
    from melonix_tpu_torch.kernels import stft as kstft
    from melonix_tpu_torch.runtime import native
    from melonix_tpu_torch.ui.colormap import colormap_lut
    from melonix_tpu_torch.utils import Timer, registry

    twins = (kpv, kres, krender, kcols, kstft, kpitch, kframes)

    oracle = load_oracle(root)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[dev.index]
    print(card)
    nvcc_v = subprocess.run([_build.nvcc_path(), "--version"],
                            capture_output=True, text=True, timeout=60,
                            check=True).stdout.strip().splitlines()[-1]
    kind = torch.cuda.get_device_name(dev)
    print(f"[1] device {kind} | {card} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda} | nvcc {nvcc_v}", flush=True)

    # -- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[2] built {lib_path} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    check(native.try_load() is not None, "native host runtime: no compiler")
    print(f"    native host runtime {native.BUILD_DIR / native.LIB_NAME} "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    ptxas:", line.strip())

    # -- inputs at the main path's shapes -----------------------------
    size, hop = mt.DEFAULT_CONFIG.stft_size, mt.DEFAULT_CONFIG.stft_hop
    x = make_song(SR, SECONDS)
    n = len(x)
    knots = mt.MapKnots.from_markers(bench_markers(mt, n), SR, n)
    plan = pv.build_pv_plan(knots, n)
    check(plan is not None and plan.n_frames <= pv.PV_CHUNK_FRAMES,
          "the 180 s song renders in one chunk")
    wav = torch.from_numpy(x).to(dev)
    win = torch.from_numpy(hann_window(size)).to(dev)
    nf = num_frames(n, size, hop)
    starts_np, da_np, _rho, f_real = pv._chunk_arrays(plan, 0, plan.n_frames)
    starts = torch.from_numpy(starts_np).to(dev)
    da = torch.from_numpy(da_np).to(dev)
    zeros = torch.zeros(size // 2 + 1, dtype=torch.float32, device=dev)
    print(f"    song {n} samples, |STFT| frames {nf}, PV frames "
          f"{plan.n_frames}, n_out {plan.n_out}", flush=True)

    # -- 3. each kernel against its plain twin ------------------------
    rows = {}

    def record(name, source, replaces, err, fn_k, fn_p, fn_lib, n_bytes,
               flops):
        """One row of the kernels line; ``fn_lib`` is the one PyTorch call
        timed beside the kernel as a yardstick (None where there is none),
        ``n_bytes`` / ``flops`` the work the bound is computed from."""
        bound_ms, bound_by = bound(n_bytes, flops)
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=replaces, launches=0, max_abs_err=err,
                          bound_ms=bound_ms, bound_by=bound_by,
                          run_kernel=fn_k, run_plain=fn_p, run_library=fn_lib)

    b1 = lambda: kpv.stft_mag(wav, win, size, hop, nf)  # noqa: E731
    b1p = lambda: kpv.stft_mag_plain(wav, win, size, hop, nf)  # noqa: E731
    got, want = b1(), b1p()
    torch.cuda.synchronize()
    s = snr_db(got, want)
    print(f"[3] B1 stft_mag: SNR {s:.1f} dB (bar < -100), max abs err "
          f"{max_err(got, want):.3e}", flush=True)
    check(got.shape == (nf, size // 2) and s < -100.0, "B1 vs twin")
    # yardstick: cuFFT's rfft of the windowed frames, made outside the timing
    frames_b1 = kpv.hop_frames(wav, size, hop, nf) * win[None, :]
    record("stft_mag", "melonix_tpu_torch/csrc/stft_mag.cu",
           "melonix_tpu/kernels/pallas_pv.py:381", max_err(got, want), b1, b1p,
           lambda: torch.fft.rfft(frames_b1),
           4 * (min(n, (nf - 1) * hop + size) + size + nf * size // 2),
           fft_flops(nf, size))

    b2 = lambda: kpv.analysis(wav, starts, win, size)  # noqa: E731
    b2p = lambda: kpv.analysis_plain(wav, starts, win, size)  # noqa: E731
    (re_k, im_k), (re_p, im_p) = b2(), b2p()
    torch.cuda.synchronize()
    s = snr_db(torch.stack([re_k, im_k]), torch.stack([re_p, im_p]))
    e = max(max_err(re_k, re_p), max_err(im_k, im_p))
    print(f"    B2 analysis: SNR {s:.1f} dB (bar < -100), max abs err {e:.3e}",
          flush=True)
    check(re_k.shape == (plan.n_frames, size // 2 + 1) and s < -100.0,
          "B2 vs twin")
    s_clip = np.clip(starts_np.astype(np.int64), 0, n - 1)
    idx_b2 = starts.long().clamp(0, n - 1)[:, None] + torch.arange(size,
                                                                   device=dev)
    frames_b2 = torch.nn.functional.pad(wav, (0, size))[idx_b2] * win[None, :]
    del idx_b2
    record("pv_analysis", "melonix_tpu_torch/csrc/pv_analysis.cu",
           "melonix_tpu/kernels/pallas_pv.py:240", e, b2, b2p,
           lambda: torch.fft.rfft(frames_b2),
           4 * covered_len(s_clip, s_clip + size, n) + nbytes(starts, win)
           + nbytes(re_k, im_k), fft_flops(plan.n_frames, size))

    b3_args = (re_k, im_k, da, win, 0, f_real, zeros, zeros, zeros, size, hop)
    b3 = lambda: kpv.synth_ola_phase(*b3_args)  # noqa: E731
    b3p = lambda: kpv.synth_ola_phase_plain(*b3_args)  # noqa: E731
    (y_k, r_k, pl_k, p0_k), (y_p, r_p, pl_p, p0_p) = b3(), b3p()
    again = b3()
    torch.cuda.synchronize()
    rms, env = rms_env(y_k, y_p)
    e = max_err(y_k, y_p)
    r_ok = float(((r_k - r_p).abs() < 1e-2).float().mean())
    det = bit_equal(again, (y_k, r_k, pl_k, p0_k))
    print(f"    B3 synth_ola_phase: rms {rms:.2e} (bar < 5e-3 of max), "
          f"envelope {env:.2e} (bar < 2e-2), max abs err {e:.3e}; carries: "
          f"phi0_eff {max_err(p0_k, p0_p):.2e}, phi_last "
          f"{max_err(pl_k, pl_p):.2e} (bars 1e-5), resid_last within 1e-2 "
          f"on {100 * r_ok:.1f}% of bins (bar 90%), equal on "
          f"{100 * float((r_k == r_p).float().mean()):.1f}%; two calls "
          f"bit-equal {det} (bar: equal)", flush=True)
    check(y_k.shape == y_p.shape == ((plan.n_frames - 1) * hop + size,),
          "B3 output length")
    check(rms < 5e-3 and env < 2e-2, "B3 waveform vs twin")
    check(max_err(p0_k, p0_p) < 1e-5 and max_err(pl_k, pl_p) < 1e-5
          and r_ok > 0.9, "B3 carries vs twin")
    check(det, "B3 two calls differ")
    # the blocked phase scan alone (B3's first three launches): psi and
    # the carries against the twin's formulas (float64 sum, rounded once)
    sc_args = (re_k, im_k, da, 0, f_real, zeros, zeros, zeros, size, hop)
    sk = kpv.phase_scan(*sc_args, lock=True)
    sp = kpv.phase_scan_plain(*sc_args, lock=True)
    torch.cuda.synchronize()
    psi_eq = float((sk[1] == sp[1]).float().mean())
    print(f"    B3 phase scan alone (lock layout: mag, psi, phi): mag equal "
          f"{torch.equal(sk[0], sp[0])}, phi equal on "
          f"{100 * float((sk[2] == sp[2]).float().mean()):.4f}%, psi equal on "
          f"{100 * psi_eq:.4f}%, max |psi - twin| {max_err(sk[1], sp[1]):.3e} "
          f"rad (max |psi| {float(sp[1].abs().max()):.1f}); resid_last within "
          f"1e-2 on {100 * float(((sk[3] - sp[3]).abs() < 1e-2).float().mean()):.1f}% "
          f"(bar 90%)", flush=True)
    check(float(((sk[3] - sp[3]).abs() < 1e-2).float().mean()) > 0.9
          and max_err(sk[4], sp[4]) < 1e-5 and max_err(sk[5], sp[5]) < 1e-5,
          "B3 phase scan carries vs twin")
    del sk, sp
    sc = lambda: kpv.phase_scan(*sc_args)  # noqa: E731
    scp = lambda: kpv.phase_scan_plain(*sc_args)  # noqa: E731
    (sr_k, si_k, _n, *c_k), (sr_p, si_p, _n, *c_p) = sc(), scp()
    check(bit_equal(sc(), (sr_k, si_k, None, *c_k)), "B3 scan two calls differ")
    e_sc = max(max_err(sr_k, sr_p), max_err(si_k, si_p))
    # yardstick: one cumsum of the (F, 1025) increments, in float64 (the
    # scan's sum) and, printed beside it, float32
    incr_sc = kpv.phase_increments(torch.atan2(im_k, re_k), da, 0, zeros,
                                   size, hop)
    incr64 = incr_sc.double()
    record("pv_phase_scan", "melonix_tpu_torch/csrc/pv_synth_ola_phase.cu",
           "melonix_tpu/kernels/pallas_pv.py:828", e_sc, sc, scp,
           lambda: torch.cumsum(incr64, dim=0),
           nbytes(re_k, im_k, da, zeros, zeros, zeros)
           + nbytes(sr_k, si_k, *c_k), 0.0)
    del sr_k, si_k, sr_p, si_p
    # yardstick: cuFFT's irfft of the half spectrum (B3's inverse DFT only;
    # the bound counts the inverse FFTs' operations, not the phase scan's)
    spec_b3 = torch.complex(re_k, im_k)
    record("pv_synth_ola_phase", "melonix_tpu_torch/csrc/pv_synth_ola_phase.cu",
           "melonix_tpu/kernels/pallas_pv.py:828", e, b3, b3p,
           lambda: torch.fft.irfft(spec_b3, n=size),
           nbytes(re_k, im_k, da, win, zeros, zeros, zeros)
           + nbytes(y_k, r_k, pl_k, p0_k), fft_flops(plan.n_frames, size))
    # a later chunk: global frame offset, padded tail, carries from above;
    # 15,027 frames, so the scan's last tile and last run are partial
    # (15,104 is 118 whole tiles of 128) and B2 pairs its last frame with
    # silence
    f_odd = plan.n_frames - 77
    m0_late, f_late = 3 * plan.n_frames, f_odd - 17
    late = (re_k[:f_odd], im_k[:f_odd], da[:f_odd], win, m0_late, f_late,
            p0_p, r_p, pl_p, size, hop)
    lk, lp = kpv.synth_ola_phase(*late), kpv.synth_ola_phase_plain(*late)
    torch.cuda.synchronize()
    rms, env = rms_env(lk[0], lp[0])
    r_ok = float(((lk[1] - lp[1]).abs() < 1e-2).float().mean())
    e_pl, e_p0 = max_err(lk[2], lp[2]), max_err(lk[3], lp[3])
    print(f"    B3 later chunk ({f_odd} frames, m0 {m0_late}, f_real {f_late})"
          f": rms {rms:.2e}, envelope {env:.2e}, phi0_eff {e_p0:.2e}, "
          f"phi_last {e_pl:.2e}, resid_last within 1e-2 on "
          f"{100 * r_ok:.1f}% of bins (same bars)", flush=True)
    check(lk[0].shape == lp[0].shape and rms < 5e-3 and env < 2e-2
          and e_p0 < 1e-5 and e_pl < 1e-5 and r_ok > 0.9, "B3 later chunk")
    (re_o, im_o), (re_op, im_op) = (kpv.analysis(wav, starts[:f_odd], win,
                                                 size),
                                    kpv.analysis_plain(wav, starts[:f_odd],
                                                       win, size))
    s = snr_db(torch.stack([re_o, im_o]), torch.stack([re_op, im_op]))
    print(f"    B2 analysis of {f_odd} frames (an odd count): SNR {s:.1f} dB "
          f"(bar < -100)", flush=True)
    check(re_o.shape == (f_odd, size // 2 + 1) and s < -100.0,
          "B2 odd frame count vs twin")
    del re_o, im_o, re_op, im_op

    y = y_k[: plan.stretch_len] / pv._ola_wsum(win, size, hop, plan.n_frames,
                                               plan.stretch_len)
    anc_j, src_f, r_f, s_f, n_real = plan.anc_np
    nb = plan.n_out_pad // kres.BLK
    a0, cnt, kmax = kres.pv_anchor_blocks(anc_j[:n_real], nb)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    anc = [put(a[:n_real]) for a in (anc_j, src_f, r_f, s_f)]
    base, a0_d, cnt_d = put(plan.base), put(a0), put(cnt)
    b4 = lambda: kres.resample_pv(  # noqa: E731
        y, base, a0_d, cnt_d, *anc, SR, plan.n_out_pad)
    b4p = lambda: kres.resample_pv_plain(  # noqa: E731
        y, base, *anc, SR, plan.n_out_pad)
    got, want = b4(), b4p()
    torch.cuda.synchronize()
    s, e = snr_db(got, want), max_err(got, want)
    print(f"    B4 resample_pv (expm1f) vs twin (expm1_precise): SNR {s:.1f} dB "
          f"(bar < -60), max abs err {e:.3e} (bar 5e-3), kmax {kmax}",
          flush=True)
    check(got.shape == (plan.n_out_pad,) and s < -60.0 and e < 5e-3,
          "B4 vs twin")
    record("resample_pv", "melonix_tpu_torch/csrc/resample_pv.cu",
           "melonix_tpu/kernels/pallas_resample.py:202", e, b4, b4p, None,
           nbytes(y, base, a0_d, cnt_d, *anc, got), 0.0)

    # expm1f (used by B4) vs the Horner expm1_precise, both against float64
    xs = torch.linspace(-0.7, 0.7, 1 << 20, device=dev)
    truth = torch.expm1(xs.double())
    ulp = lambda v: float(((v.double() - truth).abs()  # noqa: E731
                           / torch.finfo(torch.float32).eps
                           / truth.abs().clamp_min(1e-30)).max())
    print(f"    expm1 on |x| <= 0.7, max rel err in f32 eps: expm1f "
          f"{ulp(torch.expm1(xs)):.2f}, expm1_precise "
          f"{ulp(kres.expm1_precise(xs)):.2f}", flush=True)

    # -- 4. the main path ---------------------------------------------
    def pipeline():
        mags = mt.stft_mags_device(wav, win, size, hop, nf)
        out = mt.render_track_pv(wav, knots, device_out=True)
        return mags, out

    counters = (kpv.stft_mag, kpv.analysis, kpv.synth_ola_phase,
                kres.resample_pv)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    mags, out = pipeline()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    with plain_twins(*twins):
        mags_p, out_p = pipeline()
    torch.cuda.synchronize()
    check(out.shape == (plan.n_out,), f"output length {out.shape} != "
          f"{plan.n_out}")
    check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(mags).all()),
          "finite output")
    rms, env = rms_env(out, out_p)
    s = snr_db(mags, mags_p)
    cents = pitch_err_cents(mt, dev)
    print(f"[4] main path: n_out {out.shape[0]}, finite; render vs all-plain "
          f"path: rms {rms:.2e} (bar 5e-3 of max), envelope {env:.2e} (bar "
          f"2e-2); |STFT| SNR {s:.1f} dB; pitch error {cents:+.3f} cents "
          f"(bar 1)", flush=True)
    check(rms < 5e-3 and env < 2e-2 and s < -100.0, "main path vs plain")
    check(abs(cents) < 1.0, f"pitch error {cents} cents")
    # The same render in 4096-frame chunks: the phase carry through B3.  A
    # carry fault breaks phase at every chunk seam (rms ~ the signal); what
    # remains is the float32 rounding of the resid carry at each seam (the
    # sum itself is float64): the PV bars apply.
    saved, pv.PV_CHUNK_FRAMES = pv.PV_CHUNK_FRAMES, 4096
    try:
        out_c = mt.render_track_pv(wav, knots, device_out=True)
    finally:
        pv.PV_CHUNK_FRAMES = saved
    rms, env = rms_env(out_c, out)
    print(f"    chunked (4096 frames) vs one-shot render: rms {rms:.2e} "
          f"(bar 5e-3 of max), envelope {env:.2e} (bar 2e-2)", flush=True)
    check(out_c.shape == out.shape and rms < 5e-3 and env < 2e-2,
          "chunked render carry")

    # -- 5. the main path went through every kernel --------------------
    print(f"[5] launches in one main-path run: {launches}", flush=True)
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    # the scan's launches run inside every B3 call: B3's count is theirs
    for name, fn in (("stft_mag", kpv.stft_mag), ("pv_analysis", kpv.analysis),
                     ("pv_synth_ola_phase", kpv.synth_ola_phase),
                     ("pv_phase_scan", kpv.synth_ola_phase),
                     ("resample_pv", kres.resample_pv)):
        rows[name]["launches"] = launches[fn.__name__]

    # -- 6. granular host half: native runtime against NumPy -----------
    native.build_grains.calls = native.build_plan.calls = 0
    t0 = time.perf_counter()
    table = mt.build_grain_table(x)
    t_grains = time.perf_counter() - t0
    t0 = time.perf_counter()
    table_np = mt.build_grain_table(x, backend="numpy")
    t_grains_np = time.perf_counter() - t0
    t0 = time.perf_counter()
    gplan = mt.build_render_plan(table, knots)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    gplan_np = mt.build_render_plan(table_np, knots, backend="numpy")
    t_plan_np = time.perf_counter() - t0
    check(native.build_grains.calls == 1 and native.build_plan.calls == 1,
          "backend='auto' did not take the native runtime")
    check(np.array_equal(table.starts, table_np.starts)
          and np.array_equal(table.lengths, table_np.lengths),
          "native grain table != NumPy")
    for f in dataclasses.fields(gplan):
        a, b = getattr(gplan, f.name), getattr(gplan_np, f.name)
        check(np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype,
              f"native plan field {f.name} != NumPy")
    total = gplan.total_out
    t0 = time.perf_counter()
    fix_idx, fix_val = grender.seam_fixes(gplan, x, total)
    t_fix = time.perf_counter() - t0
    gmax, szmax = krender._buckets(gplan)
    offs = gplan.out_offset[:-1]
    a0g, cntg, kmax_g = krender.compact_blocks(offs, -(-total // krender.CBLK))
    n_fix = int((fix_idx < total).sum())
    print(f"[6] granular host: grains {len(table)} (native {1e3 * t_grains:.2f}"
          f" ms, NumPy {1e3 * t_grains_np:.1f} ms, equal), plan steps "
          f"{gplan.n_steps} (native {1e3 * t_plan:.2f} ms, NumPy "
          f"{1e3 * t_plan_np:.1f} ms, equal), total_out {total}, buckets "
          f"gmax {gmax} szmax {szmax}, compact kmax {kmax_g}, seam fixes "
          f"{n_fix} ({1e3 * t_fix:.2f} ms)", flush=True)

    # -- 7. B5 and B6 against their twins, bit for bit ----------------
    gs_d = put(gplan.grain_start.astype(np.int32))
    rate_d = put(gplan.rate.astype(np.float32))
    sz_d = put(gplan.sz.astype(np.int32))
    off_d = put(offs.astype(np.int32))
    a0g_d, cntg_d = put(a0g), put(cntg)
    b5 = lambda: krender.render_steps(wav, gs_d, rate_d, sz_d, szmax)  # noqa: E731
    b5p = lambda: krender.render_steps_plain(  # noqa: E731
        wav, gs_d, rate_d, sz_d, szmax)
    vals_k, vals_p = b5(), b5p()
    torch.cuda.synchronize()
    e = max_err(vals_k, vals_p)
    print(f"[7] B5 render_steps ({gplan.n_steps} x {szmax}): equal "
          f"{torch.equal(vals_k, vals_p)}, max abs err {e:.3e} (bar: equal)",
          flush=True)
    check(vals_k.shape == (gplan.n_steps, szmax) and torch.equal(vals_k, vals_p),
          "B5 vs twin")
    # B5 reads each step's grain span [gs, gs + sz * rate] (+1 lerp tap)
    g_lo = gplan.grain_start.astype(np.int64)
    g_hi = g_lo + np.ceil(gplan.sz * gplan.rate.astype(np.float64)) + 2
    record("render_steps", "melonix_tpu_torch/csrc/render_steps.cu",
           "melonix_tpu/kernels/pallas_render.py:108", e, b5, b5p, None,
           4 * covered_len(g_lo, g_hi, n) + nbytes(gs_d, rate_d, sz_d, vals_k),
           0.0)
    b6 = lambda: krender.compact(vals_k, off_d, a0g_d, cntg_d, total)  # noqa: E731
    b6p = lambda: krender.compact_plain(vals_k, off_d, total)  # noqa: E731
    got, want = b6(), b6p()
    torch.cuda.synchronize()
    e = max_err(got, want)
    print(f"    B6 compact ({total} samples): equal {torch.equal(got, want)}, "
          f"max abs err {e:.3e} (bar: equal)", flush=True)
    check(got.shape == (total,) and torch.equal(got, want), "B6 vs twin")
    # B6 reads one step value per output sample, writes the track once
    record("compact", "melonix_tpu_torch/csrc/compact.cu",
           "melonix_tpu/kernels/pallas_render.py:375", e, b6, b6p, None,
           8 * total + nbytes(off_d, a0g_d, cntg_d), 0.0)
    del vals_p, got, want

    # -- 8. the granular main path: render_track ----------------------
    def granular():
        tab = mt.build_grain_table(x)
        return mt.render_track(x, tab, knots, device=dev, device_out=True)

    gcounters = (krender.render_steps, krender.compact)
    for fn in gcounters:
        fn.launches = 0
    torch.cuda.synchronize()
    out_g = granular()
    torch.cuda.synchronize()
    glaunches = {fn.__name__: fn.launches for fn in gcounters}
    with plain_twins(*twins):
        out_gp = granular()
    rd_args = grender.render_device_args(gplan, x, total)
    out_rd = grender.render_device(
        wav, put(rd_args[0]), put(rd_args[1]), put(rd_args[2]),
        int(rd_args[3]), rd_args[4], put(rd_args[5]), put(rd_args[6]))
    torch.cuda.synchronize()
    nz = torch.nonzero(out_g).flatten()
    trailing = total - 1 - int(nz[-1]) if nz.numel() else total
    parity = granular_parity_max_err(mt, oracle, dev)
    print(f"[8] granular path: render_track n_out {out_g.shape[0]} (bar "
          f"{total}), finite, {trailing} trailing zeros (bar 1500); equal to "
          f"all-plain path {torch.equal(out_g, out_gp)}, to render_device "
          f"{torch.equal(out_g, out_rd)}; granular_parity_max_err {parity} "
          f"(bar 0.0)", flush=True)
    check(out_g.shape == (total,) and bool(torch.isfinite(out_g).all()),
          "granular output length / finite")
    check(trailing == 1500, f"{trailing} trailing zeros")
    check(torch.equal(out_g, out_gp), "render_track vs all-plain path")
    check(torch.equal(out_g, out_rd), "render_track vs render_device")
    check(parity == 0.0, f"granular_parity_max_err {parity}")
    print(f"    launches in one granular run: {glaunches}", flush=True)
    check(all(v > 0 for v in glaunches.values()),
          "a granular kernel was not launched")
    for fn in gcounters:
        rows[fn.__name__]["launches"] = glaunches[fn.__name__]
    del out_gp, out_rd
    # the CLI's default engine on the default device (cuda), 20 s of the song
    from melonix_tpu_torch.cli import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav")
        clip = x[: 20 * SR]
        mt.write_wav(src, clip, SR, dtype="float32")
        before = krender.render_steps.launches
        check(cli_main(["render", src, "-o", dst, "--dtype", "float32"]) == 0,
              "CLI render")
        cli_out, _rate = mt.read_wav(dst)
        want = mt.render_track(clip, mt.build_grain_table(clip),
                               mt.MapKnots.from_markers([], SR, len(clip)),
                               device="cpu")
        check(krender.render_steps.launches > before, "CLI ran no kernel")
        check(np.array_equal(cli_out, want), "CLI (cuda) vs render_track (cpu)")
    print("    CLI render (granular, --device cuda by default) equals the CPU "
          "render_track bit for bit", flush=True)

    # -- 9. B7 against its twin and the float64 oracle ----------------
    cfg = mt.DEFAULT_CONFIG
    csize, kgain = cfg.spectr_size, cfg.brightness_to_k()
    span = int(0.02 * SR)  # 20 ms columns: a zoomed-in view
    zoom_end = n // 3 + span * np.arange(1, 257)
    wide_s, wide_e = view_column_ranges(knots, 256, 0.0, knots.duration())
    col_sets = {"zoomed (256 x 20 ms from n / 3)": (zoom_end - span, zoom_end),
                "spread (256 columns over the edited track)": (wide_s, wide_e)}
    for label, (cs_np, ce_np) in col_sets.items():
        cs, ce = put(cs_np.astype(np.int32)), put(ce_np.astype(np.int32))
        args = (wav, cs, ce, kgain)
        mk = kcols.spectrogram_columns_fused(*args, size=csize, colormap=False)
        mp = kcols.spectrogram_columns_plain(*args, size=csize, colormap=False)
        pk = kcols.spectrogram_columns_fused(*args, size=csize)
        pp = kcols.spectrogram_columns_plain(*args, size=csize)
        torch.cuda.synchronize()
        s = snr_db(mk, mp)
        eq, dmax = planes_close(unpack_rgb(pk).cpu().numpy(),
                                unpack_rgb(pp).cpu().numpy())
        print(f"[9] B7 {label}: magnitudes SNR {s:.1f} dB (bar < -100), max "
              f"abs err {max_err(mk, mp):.3e}; packed RGB equal on "
              f"{100 * eq:.4f}% (bar 99.9), max diff {dmax} (bar 1)",
              flush=True)
        check(mk.shape == (256, csize // 2) and pk.dtype == torch.int32
              and s < -100.0, f"B7 {label} magnitudes vs twin")
        check(eq >= 0.999 and dmax <= 1, f"B7 {label} texels vs twin")
    o_end = np.linspace(csize, n - 1, 12).astype(np.int64)  # bench.py:148-150
    o_start = o_end - span
    got = mt.spectrogram_columns(x, o_start, o_end)  # NumPy in and out, cuda
    want = np.stack([column_f64(x, int(a), int(b), csize)
                     for a, b in zip(o_start, o_end)])
    s = 10.0 * np.log10(np.sum((got - want) ** 2) / np.sum(want ** 2))
    arg_eq = bool(np.array_equal(got.argmax(1), want.argmax(1)))
    print(f"    spectrogram_columns vs float64 oracle (12 columns, "
          f"bench.py:136-156): SNR {s:.1f} dB (bar < -60), argmax equal "
          f"{arg_eq}", flush=True)
    check(got.shape == (12, csize // 2) and s < -60.0 and arg_eq,
          "B7 vs float64 oracle")
    cs_t, ce_t = put(wide_s.astype(np.int32)), put(wide_e.astype(np.int32))
    b7 = lambda: kcols.spectrogram_columns_fused(  # noqa: E731
        wav, cs_t, ce_t, kgain, size=csize, colormap=False)
    b7p = lambda: kcols.spectrogram_columns_plain(  # noqa: E731
        wav, cs_t, ce_t, kgain, size=csize, colormap=False)
    frames_b7 = kcols.extract_frames(wav, cs_t, ce_t, csize, cfg.spec_decay)
    ends_c = np.clip(wide_e.astype(np.int64), 0, n + csize)
    record("spectrogram_columns",
           "melonix_tpu_torch/csrc/spectrogram_columns.cu",
           "melonix_tpu/kernels/pallas_columns.py:168", max_err(b7(), b7p()),
           b7, b7p, lambda: torch.fft.rfft(frames_b7),
           4 * covered_len(ends_c - csize, ends_c, n) + nbytes(cs_t, ce_t)
           + 4 * 256 * (csize // 2), fft_flops(256, csize))

    # -- 10. B12 against its twin; the |STFT| pyramid's two routes -----
    for sz, hp in ((4096, 1024), (1024, 256), (1536, 384)):
        w_d, nfz = put(hann_window(sz)), num_frames(n, sz, hp)
        got = kstft.stft_mag(wav, w_d, sz, hp, nfz)
        want = kstft.stft_mag_plain(wav, w_d, sz, hp, nfz)
        torch.cuda.synchronize()
        s, e = snr_db(got, want), max_err(got, want)
        print(f"[10] B12 stft_mag_sizes {sz}/{hp} ({nfz} frames): SNR "
              f"{s:.1f} dB (bar < -80), max abs err {e:.3e}", flush=True)
        check(got.shape == (nfz, sz // 2) and s < -80.0,
              f"B12 {sz}/{hp} vs twin")
        if sz == 4096:
            win12, nf12, e12 = w_d, nfz, e
    b12 = lambda: kstft.stft_mag(wav, win12, 4096, 1024, nf12)  # noqa: E731
    b12p = lambda: kstft.stft_mag_plain(  # noqa: E731
        wav, win12, 4096, 1024, nf12)
    frames_b12 = kpv.hop_frames(wav, 4096, 1024, nf12) * win12[None, :]
    record("stft_mag_sizes", "melonix_tpu_torch/csrc/stft_mag_sizes.cu",
           "melonix_tpu/kernels/pallas_stft.py:106", e12, b12, b12p,
           lambda: torch.fft.rfft(frames_b12),
           4 * (min(n, (nf12 - 1) * 1024 + 4096) + 4096 + nf12 * 2048),
           fft_flops(nf12, 4096))
    vs, ve = view_column_ranges(knots, 1280, 0.0, knots.duration())
    b1_fn, b12_fn = kpv.stft_mag, kstft.stft_mag
    for sz, hp, want_counts in ((2048, 512, (1, 0)), (4096, 1024, (0, 1))):
        b1_fn.launches = b12_fn.launches = 0
        torch.cuda.synchronize()
        pyr = mt.SpecPyramid(wav, size=sz, base_hop=hp)
        torch.cuda.synchronize()
        counts = (b1_fn.launches, b12_fn.launches)
        with plain_twins(*twins):
            pyr_p = mt.SpecPyramid(wav, size=sz, base_hop=hp)
        cols, cols_p = pyr.compute_columns(vs, ve), pyr_p.compute_columns(vs, ve)
        s = snr_db(torch.from_numpy(cols), torch.from_numpy(cols_p))
        print(f"    SpecPyramid {sz}/{hp}: {len(pyr.hops)} levels, "
              f"{pyr.nbytes() / 2**20:.1f} MiB; launches (B1, B12) {counts} "
              f"(bar {want_counts}); compute_columns over the 1280-column "
              f"viewport vs the all-plain pyramid: SNR {s:.1f} dB (bar < -100)",
              flush=True)
        check(counts == want_counts, f"SpecPyramid {sz}/{hp} kernel launches")
        check(pyr.hops == pyr_p.hops and cols.shape == (1280, sz // 2)
              and bool(np.isfinite(cols).all()) and s < -100.0,
              f"SpecPyramid {sz}/{hp} vs all-plain")
        if sz == 4096:
            rows["stft_mag_sizes"]["launches"] = counts[1]
        del pyr, pyr_p
    # the waveform min/max pyramid, built on the card (its default device),
    # against each level's blocks reduced directly in NumPy
    def blocks(reduce, lv):  # NumPy's min or max of each 2**(lv+1) block
        b = 2 << lv
        return reduce(x[: n // b * b].reshape(n // b, b), axis=1)

    wpyr = mt.build_pyramid(wav)
    n_lv = sum(1 for lv in range(64) if n > 2 << lv)
    same = wpyr.n_levels == n_lv and all(
        np.array_equal(wpyr.mins[lv], blocks(np.min, lv))
        and np.array_equal(wpyr.maxs[lv], blocks(np.max, lv))
        for lv in range(n_lv))
    wpyr_ms = host_ms(lambda: mt.build_pyramid(wav))
    wpyr_host_ms = host_ms(lambda: mt.build_pyramid(x, device="cpu"))
    print(f"    waveform pyramid: {wpyr.n_levels} levels (bar {n_lv}), equal "
          f"to NumPy's block min/max {same}; build {wpyr_ms:.2f} ms on the "
          f"card (levels to the host included), {wpyr_host_ms:.2f} ms with "
          f"device='cpu' | {card}", flush=True)
    check(same, "waveform pyramid (card) vs NumPy")

    # -- 11. the tile path: TileServer bursts and a 1280-column view ----
    lut = colormap_lut()
    b7_fn = kcols.spectrogram_columns_fused
    burst = [((i + 1) * n // 128 - span, (i + 1) * n // 128)
             for i in range(100)]  # bench.py:316-337
    cold_reqs = [(i, a, b) for i, (a, b) in enumerate(burst)]
    warm_reqs = [(1000 + i, a, b) for i, (a, b) in enumerate(burst)]
    view_reqs = [(2000 + i, int(a), int(b)) for i, (a, b) in
                 enumerate(zip(vs, ve))]

    def fill(srv, reqs, limit_s: float = 120.0):
        """Re-poll ``get_tiles`` as the UI's frame loop does until every
        tile arrived: (tiles, wall ms)."""
        t0 = time.perf_counter()
        while True:
            got = srv.get_tiles(reqs)
            if all(g is not None for g in got):
                return got, 1e3 * (time.perf_counter() - t0)
            check(time.perf_counter() - t0 < limit_s,
                  f"{sum(g is None for g in got)} tiles never arrived")
            time.sleep(0.001)

    metric = lambda name: registry(name).value  # noqa: E731
    errors0, computed0 = metric("tiles.worker_errors"), metric("tiles.computed")
    chunks0 = metric("tiles.chunks")
    b7_fn.launches = 0
    torch.cuda.synchronize()
    srv = mt.TileServer(x, k=kgain)  # asynchronous, on cuda by default
    try:
        cold, cold_ms = fill(srv, cold_reqs)
        warm, warm_ms = fill(srv, warm_reqs)
        srv.prefetch(view_reqs)
        view_tiles, view_ms = fill(srv, view_reqs)
        torch.cuda.synchronize()
        tile_launches = b7_fn.launches
        chunks = metric("tiles.chunks") - chunks0
        computed = metric("tiles.computed") - computed0
        errors = metric("tiles.worker_errors") - errors0
        # the drains on the device and the host: the burst's and the
        # viewport's columns again, under new keys
        drain = registry("tiles.drain", Timer)
        profiled = {}
        for label, key0, pos in (("burst (100 columns)", 5000, burst),
                                 ("viewport (1280 columns)", 7000,
                                  list(zip(vs, ve)))):
            reqs = [(key0 + i, int(a), int(b)) for i, (a, b) in enumerate(pos)]
            total0, count0 = drain.total, drain.count
            by_name, busy_ms, wall = device_profile(lambda: fill(srv, reqs))
            profiled[label] = (by_name, busy_ms, wall,
                               1e3 * (drain.total - total0),
                               drain.count - count0)
        settled = srv.stats()
    finally:
        srv.close()
    # the same viewport drained in the caller's thread, with no re-polling
    # thread beside it, and the host's colormap gather of one chunk
    ssrv = mt.TileServer(wav, k=kgain, synchronous=True)
    t0 = time.perf_counter()
    ssrv.get_tiles(view_reqs)
    sync_view_ms = 1e3 * (time.perf_counter() - t0)
    ssrv.close()
    v_chunk = values_of_rgb(np.stack(view_tiles[:256]), lut).astype(np.uint8)
    lut_ms = host_ms(lambda: lut[v_chunk])
    all_reqs = cold_reqs + warm_reqs + view_reqs
    with plain_twins(*twins):
        psrv = mt.TileServer(wav, k=kgain, synchronous=True)
        plain_tiles = psrv.get_tiles(all_reqs)
        psrv.close()
    tiles = cold + warm + view_tiles
    check(all(t.shape == (cfg.tile_texels, 3) and t.dtype == np.uint8
              for t in tiles + plain_tiles), "tile shape / type")
    eq, dmax = planes_close(values_of_rgb(np.stack(tiles), lut),
                            values_of_rgb(np.stack(plain_tiles), lut))
    print(f"[11] tile path: cold burst (100 columns) {cold_ms:.2f} ms, warm "
          f"burst {warm_ms:.2f} ms, 1280-column viewport {view_ms:.2f} ms "
          f"(wall, re-polled) | {card}", flush=True)
    print(f"     drains: {computed} columns in {chunks} chunks of <= 256, B7 "
          f"launches {tile_launches}, worker errors {errors}; tiles vs the "
          f"all-plain server: values equal on {100 * eq:.4f}% (bar 99.9), max "
          f"diff {dmax} (bar 1)", flush=True)
    for label, (by_name, busy_ms, wall, drain_ms, n_drains) in profiled.items():
        b7_dev = sum(v for k, v in by_name.items() if "columns_kernel" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"     profiled {label}: wall {wall:.2f} ms, worker drain "
              f"{drain_ms:.2f} ms in {n_drains} drain(s), device busy "
              f"{busy_ms:.4f} ms (idle share {1.0 - busy_ms / wall:.4f}), B7 "
              f"{b7_dev:.4f} ms; device ms by name: "
              + ", ".join(f"{k[:48]} {v:.4f}" for k, v in top)
              + f" | {card}", flush=True)
    print(f"     viewport drained synchronously (no re-polling thread): "
          f"{sync_view_ms:.2f} ms; host colormap gather (LUT) of one "
          f"256-column chunk {lut_ms:.2f} ms | {card}", flush=True)
    check(errors == 0, f"{errors} tile worker errors")
    check(computed == len(all_reqs), f"{computed} columns computed, asked "
          f"for {len(all_reqs)}")
    check(tile_launches == chunks and chunks >= 7,
          f"B7 launches {tile_launches} vs drained chunks {chunks}")
    check(eq >= 0.999 and dmax <= 1, "tiles vs the all-plain server")
    check(settled["pending"] == 0 and settled["inflight"] == 0,
          f"tile server not settled: {settled}")
    rows["spectrogram_columns"]["launches"] = tile_launches

    # -- 12. the pitch path: B8 against its twin, pitch_curve ---------
    pcfg = mt.DEFAULT_CONFIG
    pframe, phop = pcfg.pitch_frame, pcfg.pitch_hop
    pnf = 1 + (n - pframe) // phop
    b8 = lambda: kpitch.pitch_ac(wav, pframe, phop, pnf)  # noqa: E731
    b8p = lambda: kpitch.pitch_ac_plain(wav, pframe, phop, pnf)  # noqa: E731
    (ac_k, w_k), (ac_p, w_p) = b8(), b8p()
    torch.cuda.synchronize()
    s, e_w = snr_db(ac_k, ac_p), max_err(w_k, w_p)
    print(f"[12] B8 pitch_ac ({pnf} x {pframe}): ac SNR {s:.1f} dB (bar < "
          f"-100), max abs err {max_err(ac_k, ac_p):.3e}; w max abs err "
          f"{e_w:.3e} (bar 1e-5)", flush=True)
    check(ac_k.shape == w_k.shape == (pnf, pframe) and s < -100.0
          and e_w < 1e-5, "B8 vs twin")
    # yardstick: cuFFT's round trip on the twin's mean-subtracted frames
    # (rfft, |.|^2, irfft: two FFT calls and one elementwise pass)
    record("pitch_ac", "melonix_tpu_torch/csrc/pitch_ac.cu",
           "melonix_tpu/kernels/pallas_pitch.py:123", max_err(ac_k, ac_p),
           b8, b8p,
           lambda: torch.fft.irfft(torch.fft.rfft(w_p, n=2 * pframe).abs()
                                   .square(), n=2 * pframe),
           4 * min(n, (pnf - 1) * phop + pframe) + nbytes(ac_k, w_k),
           2 * fft_flops(pnf, 2 * pframe))
    del ac_k, w_k, ac_p

    kpitch.pitch_ac.launches = 0
    torch.cuda.synchronize()
    curve = mt.pitch_curve(x, SR)  # NumPy in, on cuda by default
    torch.cuda.synchronize()
    b8_launches = kpitch.pitch_ac.launches
    with plain_twins(*twins):
        curve_p = mt.pitch_curve(x, SR)
    t_c = (np.arange(len(curve.f0)) * phop + pframe // 2) / SR
    v = curve.voiced
    cents_err = np.abs(1200.0 * np.log2(curve.f0[v] / song_f0(t_c[v])))
    same_v, same_n = curves_agree(curve, curve_p)
    print(f"    pitch_curve of the song ({len(curve.f0)} frames): voiced "
          f"{100 * v.mean():.2f}% (bar 90), median error "
          f"{np.median(cents_err):.3f} cents (bar 10) against the closed-form "
          f"f0; vs the all-plain run: voicing equal on {100 * same_v:.3f}%, "
          f"notes within 0.01 st on {100 * same_n:.3f}% (bars 99.9); B8 "
          f"launches {b8_launches} (bar 1)", flush=True)
    check(len(curve.f0) == pnf and v.mean() > 0.9
          and np.median(cents_err) < 10.0, "pitch_curve vs the song's f0")
    check(same_v >= 0.999 and same_n >= 0.999, "pitch_curve vs all-plain")
    check(b8_launches == 1, f"B8 launches {b8_launches} in pitch_curve")
    rows["pitch_ac"]["launches"] = b8_launches

    # -- 13. autotune with its defaults: PV with formant preservation ---
    mel, mel_notes, mel_cents = make_melody(SR, SECONDS)
    n_mel = len(mel)
    at_counters = (kpitch.pitch_ac, kpv.analysis, kpv.synth_ola_phase,
                   kres.resample_pv)
    for fn in at_counters:
        fn.launches = 0
    torch.cuda.synchronize()
    tuned, at_markers = mt.autotune(mel, SR)  # engine pv, formants, cuda
    torch.cuda.synchronize()
    at_launches = {fn.__name__: fn.launches for fn in at_counters}
    mplan = pv.build_pv_plan(
        mt.MapKnots.from_markers(at_markers, SR, n_mel), n_mel)
    n_chunks = -(-mplan.n_frames // pv.PV_CHUNK_FRAMES)
    with plain_twins(*twins):
        tuned_p = mt.render_session(mel, at_markers, SR, engine="pv",
                                    preserve_formants=True)
        markers_p = eat.suggest_markers(mel, SR)
    check(tuned.shape == tuned_p.shape == (mplan.n_out,)
          and bool(np.isfinite(tuned).all()), "autotune output length/finite")
    rms, env = rms_env(torch.from_numpy(tuned), torch.from_numpy(tuned_p))
    same_m = (len(markers_p) == len(at_markers) and all(
        a.sample == b.sample and abs(a.pitch_bend - b.pitch_bend) < 1e-3
        for a, b in zip(at_markers, markers_p)))
    c_out = mt.pitch_curve(tuned, SR)
    t_o = (np.arange(len(c_out.note)) * phop + pframe // 2) / SR
    hits, meds = 0, []
    for i, note in enumerate(mel_notes):
        sel = c_out.voiced & (t_o > 1.5 * i + 0.25) & (t_o < 1.5 * (i + 1) - 0.25)
        med = float(np.median(c_out.note[sel])) if sel.any() else np.nan
        meds.append(med - note)
        hits += bool(abs(med - note) < 0.1)
    share = hits / len(mel_notes)
    print(f"[13] autotune (pv, formants, cuda) of a {SECONDS:.0f} s melody, "
          f"{len(mel_notes)} notes detuned {np.abs(mel_cents).min():.1f}-"
          f"{np.abs(mel_cents).max():.1f} cents: {len(at_markers)} markers; "
          f"corrected median within 10 cents of its note on {100 * share:.1f}% "
          f"of notes (bar 95), median |error| "
          f"{100 * np.nanmedian(np.abs(meds)):.3f} cents", flush=True)
    print(f"     vs the all-plain formant render of the same markers: rms "
          f"{rms:.2e} (bar 5e-3 of max), envelope {env:.2e} (bar 2e-2); "
          f"all-plain markers equal {same_m}; launches {at_launches} (bars: "
          f"B8 1, B2 and B3 once per chunk of {n_chunks}, B4 1)", flush=True)
    check(share >= 0.95, f"autotune hit its notes on {share:.3f}")
    check(rms < 5e-3 and env < 2e-2, "autotune render vs all-plain")
    check(same_m, "autotune markers vs all-plain")
    check(at_launches == {"pitch_ac": 1, "analysis": n_chunks,
                          "synth_ola_phase": n_chunks, "resample_pv": 1},
          f"autotune launches {at_launches}")
    del tuned_p

    # B3's (mag, phi) entry against its twin at the melody's chunk shapes
    st_m, da_m, rho_m, fr_m = pv._chunk_arrays(mplan, 0, mplan.n_frames)
    re_m, im_m = kpv.analysis(torch.from_numpy(mel).to(dev),
                              torch.from_numpy(st_m).to(dev), win, size)
    mag_m = torch.sqrt(re_m * re_m + im_m * im_m)
    phi_m = torch.atan2(im_m, re_m)
    del re_m, im_m
    rho_d = torch.from_numpy(rho_m).to(dev)
    gain_fn = lambda: pv._formant_gain(mag_m, rho_d, size)  # noqa: E731
    mag_m.mul_(gain_fn())
    da_d = torch.from_numpy(da_m).to(dev)
    b3f_args = (mag_m, phi_m, da_d, win, 0, fr_m, zeros, zeros, zeros, size,
                hop)
    b3f = lambda: kpv.synth_ola_phase(*b3f_args, cart=False)  # noqa: E731
    b3fp = lambda: kpv.synth_ola_phase_plain(  # noqa: E731
        *b3f_args, cart=False)
    (y_k, r_k, pl_k, p0_k), (y_p, r_p, pl_p, p0_p) = b3f(), b3fp()
    det = bit_equal(b3f(), (y_k, r_k, pl_k, p0_k))
    torch.cuda.synchronize()
    rms, env = rms_env(y_k, y_p)
    e = max_err(y_k, y_p)
    # every frame of the melody is bent, so the residual sums run to
    # thousands of radians: the bar also counts float32 spacings of |resid|
    # (eps |resid|)
    eps32 = torch.finfo(torch.float32).eps
    r_sp = (r_k - r_p).abs() / (eps32 * r_p.abs().clamp_min(1.0))
    r_q = [float(v) for v in torch.quantile(
        r_sp, torch.tensor([0.5, 0.9, 0.99], device=dev))]
    r_ok = float((r_sp <= 32.0).float().mean())
    r_abs = float(((r_k - r_p).abs() < 1e-2).float().mean())
    print(f"     B3 synth_ola_phase (mag, phi) entry: rms {rms:.2e} (bar < "
          f"5e-3 of max), envelope {env:.2e} (bar < 2e-2), max abs err "
          f"{e:.3e}; carries: phi0_eff {max_err(p0_k, p0_p):.2e}, phi_last "
          f"{max_err(pl_k, pl_p):.2e} (bars 1e-5), resid_last (median "
          f"|resid| {float(r_p.abs().median()):.1f} rad) within 1e-2 on "
          f"{100 * r_abs:.1f}% of bins and within 32 float32 spacings on "
          f"{100 * r_ok:.1f}% (bars 90%; quantiles 50/90/99%: {r_q[0]:.1f}, "
          f"{r_q[1]:.1f}, {r_q[2]:.1f} spacings); two calls bit-equal {det} "
          f"(bar: equal)", flush=True)
    check(rms < 5e-3 and env < 2e-2, "B3 (mag, phi) waveform vs twin")
    check(max_err(p0_k, p0_p) < 1e-5 and max_err(pl_k, pl_p) < 1e-5
          and r_ok > 0.9 and r_abs > 0.9, "B3 (mag, phi) carries vs twin")
    check(det, "B3 (mag, phi) two calls differ")
    spec_b3f = torch.polar(mag_m, phi_m)
    record("pv_synth_ola_phase_mag_phi",
           "melonix_tpu_torch/csrc/pv_synth_ola_phase.cu",
           "melonix_tpu/kernels/pallas_pv.py:828", e, b3f, b3fp,
           lambda: torch.fft.irfft(spec_b3f, n=size),
           nbytes(mag_m, phi_m, da_d, win, zeros, zeros, zeros)
           + nbytes(y_k, r_k, pl_k, p0_k), fft_flops(mplan.n_frames, size))
    rows["pv_synth_ola_phase_mag_phi"]["launches"] = at_launches[
        "synth_ola_phase"]
    del y_k, y_p

    # the formant gain and the autotune render on the device (profiler)
    gain_names, gain_busy, gain_wall = device_profile(gain_fn)
    at_names, at_busy, at_wall = device_profile(
        lambda: mt.render_session(mel, at_markers, SR, engine="pv",
                                  preserve_formants=True))
    top = sorted(at_names.items(), key=lambda kv: -kv[1])[:8]
    print(f"     formant gain ({mplan.n_frames} x {size // 2 + 1}, 39 "
          f"Chebyshev terms): device busy {gain_busy:.3f} ms in "
          f"{len(gain_names)} kernel names, wall {gain_wall:.3f} ms | {card}",
          flush=True)
    print(f"     profiled autotune render (formant PV, 180 s): wall "
          f"{at_wall:.2f} ms, device busy {at_busy:.3f} ms (idle share "
          f"{1.0 - at_busy / at_wall:.4f}); device ms by name: "
          + ", ".join(f"{k[:48]} {v:.3f}" for k, v in top) + f" | {card}",
          flush=True)

    # -- 14. identity phase locking: B3 lock=True, the locked render ----
    # B3's lock prologue against its twin (the twin's phase formulas, then
    # identity_lock) on the song's chunk, through both entries; with the
    # same (re, im) the kernel's correctly rounded sqrt equals the twin's,
    # so both pick the same peaks
    mag_s = torch.sqrt(re_k * re_k + im_k * im_k)
    phi_s = torch.atan2(im_k, re_k)
    for entry, a_in, b_in, cart in (("(re, im)", re_k, im_k, True),
                                    ("(mag, phi)", mag_s, phi_s, False)):
        args = (a_in, b_in, da, win, 0, f_real, zeros, zeros, zeros, size,
                hop)
        b3l = (lambda args=args, cart=cart:  # noqa: E731
               kpv.synth_ola_phase(*args, cart=cart, lock=True))
        b3lp = (lambda args=args, cart=cart:  # noqa: E731
                kpv.synth_ola_phase_plain(*args, cart=cart, lock=True))
        (y_k, r_k, pl_k, p0_k), (y_p, r_p, pl_p, p0_p) = b3l(), b3lp()
        det = bit_equal(b3l(), (y_k, r_k, pl_k, p0_k))
        torch.cuda.synchronize()
        rms, env = rms_env(y_k, y_p)
        e = max_err(y_k, y_p)
        eps32 = torch.finfo(torch.float32).eps
        r_sp = (r_k - r_p).abs() / (eps32 * r_p.abs().clamp_min(1.0))
        r_ok = float((r_sp <= 32.0).float().mean())
        r_abs = float(((r_k - r_p).abs() < 1e-2).float().mean())
        print(f"[14] B3 synth_ola_phase lock=True, {entry} entry: rms {rms:.2e} "
              f"(bar < 5e-3 of max), envelope {env:.2e} (bar < 2e-2), max abs "
              f"err {e:.3e}; phi0_eff equal {torch.equal(p0_k, p0_p)}, "
              f"phi_last equal {torch.equal(pl_k, pl_p)} (bars: equal), "
              f"resid_last within 1e-2 on {100 * r_abs:.1f}% of bins and "
              f"within 32 float32 spacings on {100 * r_ok:.1f}% (bars 90%); "
              f"two calls bit-equal {det} (bar: equal)", flush=True)
        check(y_k.shape == y_p.shape and rms < 5e-3 and env < 2e-2,
              f"B3 lock {entry} waveform vs twin")
        check(torch.equal(p0_k, p0_p) and torch.equal(pl_k, pl_p)
              and r_ok >= 0.9 and r_abs >= 0.9,
              f"B3 lock {entry} carries vs twin")
        check(det, f"B3 lock {entry} two calls differ")
        if cart:
            record("pv_synth_ola_phase_lock",
                   "melonix_tpu_torch/csrc/pv_synth_ola_phase.cu",
                   "melonix_tpu/kernels/pallas_pv.py:828", e, b3l, b3lp,
                   lambda: torch.fft.irfft(spec_b3, n=size),
                   nbytes(re_k, im_k, da, win, zeros, zeros, zeros)
                   + nbytes(y_k, r_k, pl_k, p0_k),
                   fft_flops(plan.n_frames, size))
    del mag_s, phi_s, y_k, y_p

    def locked_render():
        return mt.render_track_pv(wav, knots, phase_locking=True,
                                  device_out=True)

    pv_counters = (kpv.analysis, kpv.synth_ola_phase, kres.resample_pv,
                   kframes.extract_frames)

    def counted(fn):
        """(fn's result, launches of the PV kernels in one run of fn)."""
        for c in pv_counters:
            c.launches = 0
        torch.cuda.synchronize()
        res = fn()
        torch.cuda.synchronize()
        return res, {c.__name__: c.launches for c in pv_counters}

    out_l, lock_launches = counted(locked_render)
    with plain_twins(*twins):
        out_lp = locked_render()
    rms, env = rms_env(out_l, out_lp)
    m_c, m_l = pv_phasiness(mt, dev)
    print(f"     locked render_track_pv (180 s): n_out {out_l.shape[0]}, vs the "
          f"all-plain locked render rms {rms:.2e} (bar 5e-3 of max), envelope "
          f"{env:.2e} (bar 2e-2); launches {lock_launches} (bars: B2, B3, B4 "
          f"1, B9 0); phasiness (bench.py:226-267) classic {m_c:.4f}, locked "
          f"{m_l:.4f} (bar: locked < 0.5 x classic)", flush=True)
    check(out_l.shape == (plan.n_out,) and bool(torch.isfinite(out_l).all()),
          "locked render length / finite")
    check(rms < 5e-3 and env < 2e-2, "locked render vs all-plain")
    check(lock_launches == {"analysis": 1, "synth_ola_phase": 1,
                            "resample_pv": 1, "extract_frames": 0},
          f"locked render launches {lock_launches}")
    check(m_l < 0.5 * m_c, f"phasiness classic {m_c} locked {m_l}")
    rows["pv_synth_ola_phase_lock"]["launches"] = lock_launches[
        "synth_ola_phase"]
    del out_lp

    # -- 15. other frame sizes: B9 and the unfused natural path --------
    for sz, hp in ((4096, 1024), (1536, 384)):
        p_sz = pv.build_pv_plan(knots, n, size=sz, hop=hp)
        st_sz = put(p_sz.starts_m)
        b9 = lambda st_sz=st_sz, sz=sz: kframes.extract_frames(  # noqa: E731
            wav, st_sz, sz)
        b9p = lambda st_sz=st_sz, sz=sz: kframes.extract_frames_plain(  # noqa: E731
            wav, st_sz, sz)
        got, want = b9(), b9p()
        torch.cuda.synchronize()
        print(f"[15] B9 extract_frames {sz}/{hp} ({p_sz.n_frames} frames): "
              f"equal {torch.equal(got, want)} (bar: equal)", flush=True)
        check(got.shape == (p_sz.n_frames, sz) and torch.equal(got, want),
              f"B9 {sz} vs twin")
        if sz == 4096:
            # yardstick: one advanced-index gather from the zero-padded track
            wav_pad9 = torch.nn.functional.pad(wav, (0, sz))
            idx9 = (st_sz.long().clamp(0, n - 1)[:, None]
                    + torch.arange(sz, device=dev))
            s9 = np.clip(p_sz.starts_m.astype(np.int64), 0, n - 1)
            record("extract_frames", "melonix_tpu_torch/csrc/extract_frames.cu",
                   "melonix_tpu/kernels/pallas_frames.py:65", max_err(got, want),
                   b9, b9p, lambda: wav_pad9[idx9],
                   4 * covered_len(s9, s9 + sz, n) + nbytes(st_sz, got), 0.0)
        del got, want
    for sz, hp in ((4096, 1024), (1000, 250)):
        p_sz = pv.build_pv_plan(knots, n, size=sz, hop=hp)
        n_ch = -(-p_sz.n_frames // pv.PV_CHUNK_FRAMES)
        render_sz = (lambda sz=sz, hp=hp:  # noqa: E731
                     mt.render_track_pv(wav, knots, size=sz, hop=hp,
                                        device_out=True))
        o_sz, sz_launches = counted(render_sz)
        with plain_twins(*twins):
            o_szp = render_sz()
        rms, env = rms_env(o_sz, o_szp)
        want_l = {"analysis": 0, "synth_ola_phase": 0, "resample_pv": 1,
                  "extract_frames": n_ch if kframes.supported(sz) else 0}
        print(f"     render_track_pv at {sz}/{hp} ({p_sz.n_frames} frames, "
              f"{n_ch} chunk(s)): vs the all-plain render rms {rms:.2e} (bar "
              f"5e-3 of max), envelope {env:.2e} (bar 2e-2); launches "
              f"{sz_launches} (bars {want_l})", flush=True)
        check(o_sz.shape == (plan.n_out,) and bool(torch.isfinite(o_sz).all()),
              f"{sz}/{hp} render length / finite")
        check(rms < 5e-3 and env < 2e-2, f"{sz}/{hp} render vs all-plain")
        check(sz_launches == want_l, f"{sz}/{hp} launches {sz_launches}")
        if sz == 4096:
            rows["extract_frames"]["launches"] = sz_launches["extract_frames"]
            render_4096 = render_sz
        del o_sz, o_szp
    cents4 = pitch_err_cents(mt, dev, 4096, 1024)
    o4l = mt.render_track_pv(wav, knots, size=4096, hop=1024,
                             phase_locking=True, device_out=True)
    torch.cuda.synchronize()
    print(f"     pitch error at 4096/1024 {cents4:+.3f} cents (bar 1); locked "
          f"4096/1024 render: n_out {o4l.shape[0]}, finite "
          f"{bool(torch.isfinite(o4l).all())}", flush=True)
    check(abs(cents4) < 1.0, f"pitch error at 4096: {cents4} cents")
    check(o4l.shape == (plan.n_out,) and bool(torch.isfinite(o4l).all()),
          "locked 4096 render")
    del o4l

    # -- 16. stereo: a locked multichannel PV session ------------------
    st = np.ascontiguousarray(np.stack([x, 0.8 * x[::-1]], axis=1),
                              dtype=np.float32)
    markers = bench_markers(mt, n)
    t0 = time.perf_counter()
    (out_st, st_launches) = counted(lambda: mt.render_session(
        st, markers, SR, engine="pv", phase_locking=True))
    st_ms = 1e3 * (time.perf_counter() - t0)
    same = [np.array_equal(out_st[:, c], mt.render_track_pv(
        np.ascontiguousarray(st[:, c]), knots, phase_locking=True))
        for c in range(2)]
    print(f"[16] stereo locked PV session (180 s x 2, cuda by default): shape "
          f"{out_st.shape}, {st_ms:.2f} ms wall; each channel equal to its "
          f"mono render_track_pv {same} (bar: equal); launches {st_launches} "
          f"(bars: B2, B3 2 per chunk of 1, B4 2)", flush=True)
    check(out_st.shape == (plan.n_out, 2) and bool(np.isfinite(out_st).all()),
          "stereo session shape / finite")
    check(all(same), "stereo channel vs its mono render")
    check(st_launches == {"analysis": 2, "synth_ola_phase": 2,
                          "resample_pv": 2, "extract_frames": 0},
          f"stereo launches {st_launches}")
    del out_st

    # -- 17. live: B11, PvStream, the Player ---------------------------
    kres.resample_lerp.launches = 0
    torch.cuda.synchronize()
    strm = mt.PvStream(wav, knots)  # the track's device: cuda
    pulls = []
    while not strm.exhausted:
        pulls.append(strm.read(1024))
    torch.cuda.synchronize()
    reads = len(pulls)
    b11_launches = kres.resample_lerp.launches
    live = torch.from_numpy(np.concatenate(pulls)[: plan.n_out]).to(dev)
    rms, env = rms_env(live, out)
    print(f"[17] PvStream from t = 0 in 1024-sample reads: {reads} reads, B11 "
          f"launches {b11_launches} (bar: = reads); vs the card's offline "
          f"render rms {rms:.2e} (bar 5e-3 of max), envelope {env:.2e} (bar "
          f"2e-2)", flush=True)
    check(live.shape == out.shape and rms < 5e-3 and env < 2e-2,
          "stream vs offline render")
    check(b11_launches == reads == -(-plan.n_out // 1024),
          f"B11 launches {b11_launches}, reads {reads}")
    y_n, pos_n, base_n, rows_n = strm._y_norm, strm._pos, strm._base, strm._rows
    got = kres.resample_lerp(y_n, pos_n, base_n, rows_n)
    want = kres.resample_lerp_plain(y_n, pos_n, base_n, rows_n)
    j_mid = (plan.n_out // 2) // kres.BLK * kres.BLK  # one read's two blocks
    pos_r, base_r = pos_n[j_mid : j_mid + 2 * kres.BLK], base_n[
        j_mid // kres.BLK : j_mid // kres.BLK + 2]
    b11 = lambda: kres.resample_lerp(y_n, pos_r, base_r, rows_n)  # noqa: E731
    b11p = lambda: kres.resample_lerp_plain(  # noqa: E731
        y_n, pos_r, base_r, rows_n)
    got_r, want_r = b11(), b11p()
    torch.cuda.synchronize()
    print(f"     B11 resample_lerp vs twin: whole padded output "
          f"({pos_n.shape[0]} samples) equal {torch.equal(got, want)}, one "
          f"read's two blocks equal {torch.equal(got_r, want_r)} (bars: "
          f"equal); slab rows {rows_n}", flush=True)
    check(torch.equal(got, want) and torch.equal(got_r, want_r), "B11 vs twin")
    b11_full_ms = cuda_ms(lambda: kres.resample_lerp(y_n, pos_n, base_n,
                                                     rows_n))
    # the bytes one read needs: its positions and bases, the taps it
    # touches, its output
    i0 = (base_r.long().repeat_interleave(kres.BLK)
          + torch.floor(pos_r).clamp(0, rows_n * 128 - 2).long())
    taps = int(torch.unique(torch.cat([i0, i0 + 1])).numel())
    record("resample_lerp", "melonix_tpu_torch/csrc/resample_lerp.cu",
           "melonix_tpu/kernels/pallas_resample.py:248",
           max_err(got_r, want_r), b11, b11p, None,
           4 * taps + nbytes(pos_r, base_r, got_r), 0.0)
    rows["resample_lerp"]["launches"] = b11_launches
    del got, want, live, pulls

    # the bench's interactive fixtures (bench.py:341-369): edit to audio
    short = x[: 20 * SR]
    table_s = mt.build_grain_table(short)
    flat = mt.MapKnots.from_markers([], SR, len(short))
    bent = mt.MapKnots.from_markers(
        [mt.Marker(SR, 57.0, 0.0, 4.0), mt.Marker(10 * SR, 57.0, 0.0, 4.0)],
        SR, len(short))
    e2a, pitch_after = {}, {}
    for engine in ("granular", "pv"):
        player = mt.Player(short, table_s, flat, engine=engine)
        check(isinstance(player._backlog, native.Ring),
              "the player's backlog is not the native ring")
        player.toggle()
        player.callback(1024)  # warm: backlog planned / stream stretched
        t0 = time.perf_counter()
        player.set_knots(bent)  # the edit
        buf = player.callback(1024)  # first fresh buffer on the new curve
        e2a[engine] = 1e3 * (time.perf_counter() - t0)
        check(bool(np.isfinite(buf).all()) and np.abs(buf).max() > 1e-3,
              f"{engine}: the first buffer after the edit is silent")
        # the same edit made on the +4 st plateau: the first buffer's pitch
        player.set_knots(flat)
        player.seek(5.0)
        player.callback(1024)
        player.set_knots(bent)
        t_buf = player.cursor_sec
        buf = player.callback(1024)
        f0 = float(song_f0(np.asarray([t_buf + 512 / SR]))[0])
        f_got = dominant_hz(buf, SR, f0 * 2 ** (-2 / 12), f0 * 2 ** (7 / 12))
        pitch_after[engine] = 1200.0 * np.log2(f_got / (f0 * 2 ** (4 / 12)))
        check(np.abs(buf).max() > 1e-3 and abs(pitch_after[engine]) < 50.0,
              f"{engine}: first buffer after the edit at "
              f"{pitch_after[engine]:+.1f} cents from the bent pitch")
    live_stats = live_pv_sustained(mt, 15.0)
    print(f"     edit to audio (20 s clip, +4 st edit, first 1024-sample "
          f"buffer): edit_to_audio_pv_ms {e2a['pv']:.3f}, "
          f"edit_to_audio_granular_ms {e2a['granular']:.3f}; the first "
          f"buffer after the same edit on the plateau at "
          f"{pitch_after['pv']:+.2f} (pv) and {pitch_after['granular']:+.2f} "
          f"(granular) cents from the bent f0 (bar 50: one buffer's "
          f"resolution); backlog: the native ring | {card}", flush=True)
    print(f"     sustained live PV (15 s of 1024-sample pulls, bench.py:574-622"
          f"): live_pv_underruns {live_stats['live_pv_underruns']}, "
          f"live_pv_x_realtime {live_stats['live_pv_x_realtime']:.2f}, "
          f"live_pv_worst_lag_ms {live_stats['live_pv_worst_lag_ms']:.3f} | "
          f"{card}", flush=True)
    check(live_stats["live_pv_x_realtime"] > 1.0, "live PV below realtime")

    def live_reads():  # 200 pulls of 1024 (4.6 s of audio) from a restart
        s_live = mt.PvStream(wav, knots, start_sec=60.0)
        for _ in range(200):
            s_live.read(1024)

    # -- 18. B10 against its twin at the song's shapes ---------------
    # mag: the song's analysis magnitudes (B2 above); psi: their phases plus
    # seeded offsets of the size the residual phase sums reach (median
    # |resid| ~3.4e4 rad, phase 13)
    mag10 = torch.sqrt(re_k * re_k + im_k * im_k)
    psi10 = torch.atan2(im_k, re_k) + torch.from_numpy(
        np.random.default_rng(10).uniform(-4e4, 4e4, tuple(mag10.shape))
        .astype(np.float32)).to(dev)
    kpv.synth_ola.launches = 0
    b10 = lambda: kpv.synth_ola(mag10, psi10, win, size, hop)  # noqa: E731
    b10p = lambda: kpv.synth_ola_plain(mag10, psi10, win, size, hop)  # noqa: E731
    got, want = b10(), b10p()
    torch.cuda.synchronize()
    s, e = snr_db(got, want), max_err(got, want)
    b10_calls = kpv.synth_ola.launches
    print(f"[18] B10 synth_ola ({mag10.shape[0]} frames, |psi| up to 4e4): "
          f"SNR {s:.1f} dB (bar < -100), max abs err {e:.3e}; launches "
          f"{b10_calls} (bar 1 a call)", flush=True)
    check(got.shape == ((mag10.shape[0] - 1) * hop + size,) and s < -100.0,
          "B10 vs twin")
    check(b10_calls == 1, f"B10 launches {b10_calls} in one call")
    spec_b10 = torch.polar(mag10, psi10)
    record("pv_synth_ola", "melonix_tpu_torch/csrc/pv_synth_ola.cu",
           "melonix_tpu/kernels/pallas_pv.py:492", e, b10, b10p,
           lambda: torch.fft.irfft(spec_b10, n=size),
           nbytes(mag10, psi10, win, got), fft_flops(mag10.shape[0], size))
    del got, want

    # -- 19. B7 and B12 above 49,152 points: the four-step route -------
    big = 65536
    ends65 = np.linspace(big // 2, n - 1, 64).astype(np.int64)
    cs65, ce65 = put((ends65 - span).astype(np.int32)), put(
        ends65.astype(np.int32))
    b7b = lambda: kcols.spectrogram_columns_fused(  # noqa: E731
        wav, cs65, ce65, kgain, size=big, colormap=False)
    b7bp = lambda: kcols.spectrogram_columns_plain(  # noqa: E731
        wav, cs65, ce65, kgain, size=big, colormap=False)
    mk, mp = b7b(), b7bp()
    pk = kcols.spectrogram_columns_fused(wav, cs65, ce65, kgain, size=big)
    pp = kcols.spectrogram_columns_plain(wav, cs65, ce65, kgain, size=big)
    torch.cuda.synchronize()
    s7, e7 = snr_db(mk, mp), max_err(mk, mp)
    eq, dmax = planes_close(unpack_rgb(pk).cpu().numpy(),
                            unpack_rgb(pp).cpu().numpy())
    o_end = np.linspace(big, n - 1, 12).astype(np.int64)
    cfg65 = dataclasses.replace(cfg, spectr_size=big)
    kcols.spectrogram_columns_fused.launches = 0
    got = mt.spectrogram_columns(x, o_end - span, o_end, cfg65)  # NumPy, cuda
    b7b_launches = kcols.spectrogram_columns_fused.launches
    want = np.stack([column_f64(x, int(a), int(b), big)
                     for a, b in zip(o_end - span, o_end)])
    s7o = 10.0 * np.log10(np.sum((got - want) ** 2) / np.sum(want ** 2))
    print(f"[19] B7 at {big} points (four-step, 64 columns): SNR {s7:.1f} dB "
          f"vs twin (bar < -100), max abs err {e7:.3e}; packed RGB equal on "
          f"{100 * eq:.4f}% (bar 99.9), max diff {dmax} (bar 1); "
          f"spectrogram_columns (12 columns) vs float64 oracle {s7o:.1f} dB "
          f"(bar < -60), B7 launches {b7b_launches} (bar 1)", flush=True)
    check(mk.shape == (64, big // 2) and s7 < -100.0, "B7 65536 vs twin")
    check(eq >= 0.999 and dmax <= 1, "B7 65536 texels vs twin")
    check(got.shape == (12, big // 2) and s7o < -60.0 and b7b_launches == 1,
          "B7 65536 vs float64 oracle")
    frames_b7b = kcols.extract_frames(wav, cs65, ce65, big, cfg.spec_decay)
    record("spectrogram_columns_65536",
           "melonix_tpu_torch/csrc/spectrogram_columns.cu",
           "melonix_tpu/kernels/pallas_columns.py:168", e7, b7b, b7bp,
           lambda: torch.fft.rfft(frames_b7b),
           4 * covered_len(ends65 - big, ends65, n) + nbytes(cs65, ce65, mk),
           fft_flops(64, big))
    rows["spectrogram_columns_65536"]["launches"] = b7b_launches
    hop65 = big // 8
    win65, nf65 = put(hann_window(big)), num_frames(n, big, hop65)
    b12b = lambda: kstft.stft_mag(wav, win65, big, hop65, nf65)  # noqa: E731
    b12bp = lambda: kstft.stft_mag_plain(  # noqa: E731
        wav, win65, big, hop65, nf65)
    got, want = b12b(), b12bp()
    torch.cuda.synchronize()
    s12, e12b = snr_db(got, want), max_err(got, want)
    pick = np.linspace(0, nf65 - 1, 8).astype(np.int64)
    fr64 = np.stack([x[f * hop65 : f * hop65 + big] for f in pick]
                    ).astype(np.float64) * hann_window(big).astype(np.float64)
    o64 = np.abs(np.fft.rfft(fr64)[:, : big // 2])
    s12o = 10.0 * np.log10(np.sum((got[pick].cpu().numpy() - o64) ** 2)
                           / np.sum(o64 ** 2))
    kstft.stft_mag.launches = 0
    mags65 = mt.stft_mags_device(wav, win65, big, hop65, nf65)
    torch.cuda.synchronize()
    b12b_launches = kstft.stft_mag.launches
    print(f"     B12 at {big}/{hop65} (four-step, {nf65} frames): SNR "
          f"{s12:.1f} dB vs twin (bar < -80), max abs err {e12b:.3e}; 8 frames "
          f"vs float64 |rfft| {s12o:.1f} dB (bar < -60); stft_mags_device "
          f"launches {b12b_launches} (bar 1)", flush=True)
    check(got.shape == (nf65, big // 2) and s12 < -80.0, "B12 65536 vs twin")
    check(s12o < -60.0 and b12b_launches == 1
          and bool(torch.equal(mags65, got)), "B12 65536 vs float64 oracle")
    frames_b12b = kpv.hop_frames(wav, big, hop65, nf65) * win65[None, :]
    record("stft_mag_sizes_65536", "melonix_tpu_torch/csrc/stft_mag_sizes.cu",
           "melonix_tpu/kernels/pallas_stft.py:106", e12b, b12b, b12bp,
           lambda: torch.fft.rfft(frames_b12b),
           4 * (min(n, (nf65 - 1) * hop65 + big) + big + nf65 * big // 2),
           fft_flops(nf65, big))
    rows["stft_mag_sizes_65536"]["launches"] = b12b_launches
    del got, want, mk, mp, pk, pp, mags65
    # an odd factor above 12,288: the four-step route's direct column sums
    odd = 512 * 12289  # N1 512, N2 12,289 (prime)
    hop_o, nf_o = odd // 4, 2
    win_o = put(hann_window(odd))
    b12o = lambda: kstft.stft_mag(wav, win_o, odd, hop_o, nf_o)  # noqa: E731
    b12op = lambda: kstft.stft_mag_plain(  # noqa: E731
        wav, win_o, odd, hop_o, nf_o)
    kstft.stft_mag.launches = 0
    got, want = b12o(), b12op()
    torch.cuda.synchronize()
    b12o_launches = kstft.stft_mag.launches
    so, eo = snr_db(got, want), max_err(got, want)
    fr64 = np.stack([x[f * hop_o : f * hop_o + odd] for f in range(nf_o)]
                    ).astype(np.float64) * hann_window(odd).astype(np.float64)
    o64 = np.abs(np.fft.rfft(fr64)[:, : odd // 2])
    soo = 10.0 * np.log10(np.sum((got.cpu().numpy() - o64) ** 2)
                          / np.sum(o64 ** 2))
    print(f"     B12 at {odd}/{hop_o} (odd factor 12,289: plan "
          f"{kstft.four_step_plan(odd)}, direct column sums; {nf_o} frames): "
          f"SNR {so:.1f} dB vs twin (bar < -80), max abs err {eo:.3e}; vs "
          f"float64 |rfft| {soo:.1f} dB (bar < -60); launches {b12o_launches}"
          f" (bar 1)", flush=True)
    check(kstft.four_step_plan(odd) == (512, 12289)
          and got.shape == (nf_o, odd // 2) and so < -80.0 and soo < -60.0
          and b12o_launches == 1, "B12 direct column sums")
    frames_b12o = kpv.hop_frames(wav, odd, hop_o, nf_o) * win_o[None, :]
    record("stft_mag_sizes_direct", "melonix_tpu_torch/csrc/stft_mag_sizes.cu",
           "melonix_tpu/kernels/pallas_stft.py:106", eo, b12o, b12op,
           lambda: torch.fft.rfft(frames_b12o),
           4 * (min(n, (nf_o - 1) * hop_o + odd) + odd + nf_o * odd // 2),
           fft_flops(nf_o, odd))
    rows["stft_mag_sizes_direct"].update(launches=b12o_launches, inner=1)
    del got, want, fr64, o64

    # -- 20. two ranks on gloo, each on this card ----------------------
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.closing(socket.socket()) as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        world = 2
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--port", str(port), "--out", tmp])
            for r in range(world)]
        try:
            codes = [p.wait(timeout=420) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(codes == [0] * world, f"gloo ranks exited {codes}")
        rk = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                rk.append(json.load(f))
        seq_out = [np.load(os.path.join(tmp, f"seq_pv_rank{r}.npy"))
                   for r in range(world)]
    # The reference: the same formulas with the phase sum formed exactly
    # (float64, rounded once), held in the JAX suite's quarter-second form
    # at its bars (test_parallel.py:219-231), both the seq-parallel PV and
    # the single render (B3's blocked scan sums in float64 too).  The seq
    # PV is also held to the single render in this script's peak form (2e-3
    # of max, 2e-2) and read in both forms.
    exact = pv_sum_order_render(mt, x, bench_markers(mt, n), dev)
    want = out.cpu().numpy()  # render_track_pv of the song on the card
    rms_x, env_x = rms_rel_env(seq_out[0], exact, SR)
    rms_1, env_1 = rms_rel_env(want, exact, SR)
    rms_s, env_s = rms_env(torch.from_numpy(seq_out[0]), out.cpu())
    rms_q, env_q = rms_rel_env(seq_out[0], want, SR)
    same_ranks = all(np.array_equal(o, seq_out[0]) for o in seq_out)
    print(f"[20] seq-parallel PV of the {SECONDS:.0f} s song on 2 gloo ranks "
          f"(data=1, seq=2, each rank on cuda:0): vs the exact phase sum rms "
          f"{rms_x:.3e} of rms (bar 2e-3), envelope {env_x:.3e} (bar 2e-2); "
          f"render_track_pv vs the exact sum: rms {rms_1:.3e} of rms (bar "
          f"2e-3), envelope {env_1:.3e} (bar 2e-2); seq-parallel PV "
          f"vs render_track_pv rms {rms_s:.3e} of "
          f"max (bar 2e-3), envelope {env_s:.3e} (bar 2e-2), quarter-second "
          f"form rms {rms_q:.3e} of rms, envelope {env_q:.3e}; both ranks "
          f"return the whole track, equal {same_ranks}", flush=True)
    for r in rk:
        b = r["b10_vs_twin"]
        print(f"     rank {r['rank']}: B10 on its own operands ({b['frames']} "
              f"frames, {b['live']} live, |psi| up to {b['max_abs_psi']:.4g}) "
              f"vs its twin: SNR {b['snr_db']:.1f} dB (bar < -100), max abs "
              f"err {b['max_abs_err']:.3e}", flush=True)
        check(b["same_shape"] and b["snr_db"] < -100.0,
              f"rank {r['rank']}: B10 vs twin on the seq path's operands")
        q = r["seq_pv"]
        print(f"     rank {r['rank']}: wall {q['wall_ms']:.2f} ms, of it "
              f"{q['gathers']} host-staged all-gathers {q['gather_ms']:.2f} ms "
              f"({q['gather_bytes'] / 2**20:.1f} MiB sent); launches "
              f"{q['launches']} (bars: B2 1, B10 1, B3 0) | {card}",
              flush=True)
        pr = q["profile"]
        print(f"       profiled: device busy {pr['busy_ms']:.3f} ms of "
              f"{pr['wall_ms']:.2f} ms wall (idle share "
              f"{1.0 - pr['busy_ms'] / pr['wall_ms']:.4f}); device ms by "
              f"name: " + ", ".join(f"{k} {v:.3f}" for k, v in pr["top"]),
              flush=True)
        check(q["launches"]["analysis"] == 1 and q["launches"]["synth_ola"] == 1
              and q["launches"]["synth_ola_phase"] == 0,
              f"rank {r['rank']} seq PV launches {q['launches']}")
    check(seq_out[0].shape == want.shape == exact.shape and same_ranks
          and rms_x < 2e-3 and env_x < 2e-2, "seq-parallel PV vs exact sum")
    check(rms_1 < 2e-3 and env_1 < 2e-2, "render_track_pv vs exact sum")
    check(rms_s < 2e-3 and env_s < 2e-2, "seq-parallel PV vs single")
    rows["pv_synth_ola"]["launches"] = rk[0]["seq_pv"]["launches"]["synth_ola"]
    r0 = rk[0]
    g_ok = all(a and e <= 2e-6 and z for a, e, z in
               r0["batch_granular"]["vs_render_session"])
    p_ok = all(a and v < -60.0 for a, v in r0["batch_pv"]["vs_render_session"])
    for engine in ("granular", "pv"):
        for r in rk:
            q = r[f"batch_{engine}"]
            print(f"     render_batch of 4 jobs, {engine}, (data=2, seq=1), "
                  f"rank {r['rank']}: wall {q['wall_ms']:.2f} ms, gathers "
                  f"{q['gather_ms']:.2f} ms ({q['gather_bytes'] / 2**20:.1f} "
                  f"MiB); launches {q['launches']} | {card}", flush=True)
            pr = q["profile"]
            print(f"       profiled: device busy {pr['busy_ms']:.3f} ms of "
                  f"{pr['wall_ms']:.2f} ms wall (idle share "
                  f"{1.0 - pr['busy_ms'] / pr['wall_ms']:.4f}); device ms by "
                  f"name: " + ", ".join(f"{k} {v:.3f}" for k, v in pr["top"]),
                  flush=True)
    print(f"     batch vs per-job render_session: granular [len ok, max err, "
          f"zeros equal] {r0['batch_granular']['vs_render_session']} (bar "
          f"2e-6); pv [len ok, SNR dB] {r0['batch_pv']['vs_render_session']} "
          f"(bar < -60)", flush=True)
    check(g_ok and p_ok, "render_batch on 2 ranks vs render_session")
    for engine in ("granular", "pv"):
        ok, e, z = r0[f"stereo_{engine}"]["vs_no_mesh"]
        q = r0[f"stereo_{engine}"]
        print(f"     stereo {engine} session, channels over data: vs "
              f"mesh=None max err {e:.3e} (bar {'2e-6' if engine == 'granular' else 'equal'}), "
              f"zeros equal {z}; rank 0 wall {q['wall_ms']:.2f} ms", flush=True)
        check(ok and z and (e <= 2e-6 if engine == "granular" else e == 0.0),
              f"stereo {engine} session over data")

    # -- 21. world size 1: render_batch and the CLI's batch ------------
    tracks_b, ms_b = batch_jobs(mt, x)
    for engine in ("granular", "pv"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = mt.render_batch(tracks_b, ms_b, SR, engine=engine)
        b1_ms = 1e3 * (time.perf_counter() - t0)
        same = [np.array_equal(o, mt.render_session(t, m, SR, engine=engine,
                                                    mesh=None))
                for t, m, o in zip(tracks_b, ms_b, outs)]
        print(f"[21] render_batch of 4 jobs at world size 1 ({engine}): "
              f"{b1_ms:.2f} ms wall (one run, NumPy in and out); each equal "
              f"to its render_session {same} (bar: equal) | {card}",
              flush=True)
        check(all(same), f"render_batch {engine} at world 1")
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(3):
            mt.write_wav(os.path.join(tmp, f"take{i}.wav"),
                         x[i * 20 * SR : (i + 1) * 20 * SR], SR,
                         dtype="float32")
        mjson = os.path.join(tmp, "m.json")
        with open(mjson, "w") as f:
            f.write(mt.markers_to_json(bench_markers(mt, 20 * SR)[:4]))
        outdir = os.path.join(tmp, "out")
        check(cli_main(["batch", os.path.join(tmp, "take*.wav"), "--markers",
                        mjson, "-o", outdir]) == 0, "CLI batch")
        same = []
        for i in range(3):
            one = os.path.join(tmp, f"one{i}.wav")
            check(cli_main(["render", os.path.join(tmp, f"take{i}.wav"),
                            "--markers", mjson, "--engine", "pv", "--formant",
                            "-o", one]) == 0, "CLI render")
            a_, _r = mt.read_wav(os.path.join(outdir, f"take{i}.wav"))
            b_, _r = mt.read_wav(one)
            same.append(bool(np.array_equal(a_, b_)))
    print(f"     CLI batch of 3 WAVs (pv with formants, the default) vs per-"
          f"file render --engine pv --formant: equal {same} (bar: equal)",
          flush=True)
    check(all(same), "CLI batch vs render")

    # -- 22. times (CUDA events, median of 5 after a warm-up) ---------
    for r in rows.values():
        inner = r.pop("inner", KERNEL_INNER)
        r["ms"] = cuda_ms(r.pop("run_kernel"), inner=inner)
        r["plain_ms"] = cuda_ms(r.pop("run_plain"), inner=inner)
        lib = r.pop("run_library")
        r["library_ms"] = (None if lib is None else cuda_ms(lib, inner=inner))
        lib_txt = ("none" if lib is None
                   else f"{r['library_ms']:.4f} ms")
        print(f"[22] {r['name']}: kernel {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms, one PyTorch call {lib_txt}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); launches on its "
              f"main path {r['launches']} (mean of {inner} "
              f"back-to-back calls) | {card}", flush=True)
    cumsum32_ms = cuda_ms(lambda: torch.cumsum(incr_sc, dim=0),
                          inner=KERNEL_INNER)
    print(f"[22] B3's phase scan yardsticks: torch.cumsum of the "
          f"{tuple(incr_sc.shape)} increments {cumsum32_ms:.4f} ms in float32, "
          f"{rows['pv_phase_scan']['library_ms']:.4f} ms in float64; B3's "
          f"synthesis + OLA launches (B3 less the scan alone) "
          f"{rows['pv_synth_ola_phase']['ms'] - rows['pv_phase_scan']['ms']:.4f}"
          f" ms | {card}", flush=True)
    dev_args = (wav, gplan.grain_start, gplan.rate, gplan.sz, offs, total,
                fix_idx, fix_val, szmax)
    g_dev_ms = cuda_ms(lambda: krender.render_full(*dev_args))
    with plain_twins(*twins):
        g_dev_plain_ms = cuda_ms(lambda: krender.render_full(*dev_args))
    g_wall_ms = host_ms(granular)
    g_grains_ms = host_ms(lambda: mt.build_grain_table(x))
    g_plan_ms = host_ms(lambda: mt.build_render_plan(table, knots))
    g_fix_ms = host_ms(lambda: grender.seam_fixes(gplan, x, total))
    print(f"[22] granular path ({SECONDS:.0f} s): wall {g_wall_ms:.2f} ms = "
          f"host grains {g_grains_ms:.2f} + plan {g_plan_ms:.2f} + seam fixes "
          f"{g_fix_ms:.2f} ms + device part (uploads, B5, B6, fixes) "
          f"{g_dev_ms:.3f} ms with the kernels, {g_dev_plain_ms:.3f} ms "
          f"all-plain | {card}", flush=True)
    path_ms = cuda_ms(pipeline)
    with plain_twins(*twins):
        plain_path_ms = cuda_ms(pipeline)
    print(f"[22] main path (|STFT| + PV render of {SECONDS:.0f} s, host plan "
          f"included): {path_ms:.2f} ms with the kernels, {plain_path_ms:.2f} "
          f"ms all-plain | {card}", flush=True)
    pc_ms = host_ms(lambda: mt.pitch_curve(x, SR))
    with plain_twins(*twins):
        pc_plain_ms = host_ms(lambda: mt.pitch_curve(x, SR))
    pc_names, pc_busy, pc_wall = device_profile(lambda: mt.pitch_curve(x, SR))
    top = sorted(pc_names.items(), key=lambda kv: -kv[1])[:8]
    print(f"[22] pitch path (pitch_curve of {SECONDS:.0f} s, upload and host "
          f"float64 part included): {pc_ms:.2f} ms with B8, {pc_plain_ms:.2f} "
          f"ms all-plain; profiled: device busy {pc_busy:.3f} ms of "
          f"{pc_wall:.2f} ms wall (idle share {1.0 - pc_busy / pc_wall:.4f}), "
          f"B8 {sum(v for k, v in pc_names.items() if 'pitch_ac' in k):.3f} "
          f"ms; device ms by name: "
          + ", ".join(f"{k[:48]} {v:.3f}" for k, v in top) + f" | {card}",
          flush=True)
    detect_ms = host_ms(lambda: mt.pitch_curve(mel, SR))
    suggest_ms = host_ms(lambda: eat.suggest_markers(mel, SR))
    render_ms = host_ms(lambda: mt.render_session(
        mel, at_markers, SR, engine="pv", preserve_formants=True))
    at_ms = host_ms(lambda: mt.autotune(mel, SR))
    with plain_twins(*twins):
        at_plain_ms = host_ms(lambda: mt.autotune(mel, SR))
    print(f"[22] autotune path ({SECONDS:.0f} s melody, defaults): {at_ms:.2f} "
          f"ms wall with the kernels ({at_plain_ms:.2f} ms all-plain) = detect "
          f"(pitch_curve) {detect_ms:.2f} + suggest (host segmentation and "
          f"snap) {suggest_ms - detect_ms:.2f} + render (formant PV) "
          f"{render_ms:.2f} ms; formant gain device time {gain_busy:.3f} ms"
          f" | {card}", flush=True)
    def stereo_session():
        return mt.render_session(st, markers, SR, engine="pv",
                                 phase_locking=True)

    for label, fn in (("locked PV render", locked_render),
                      ("PV render at 4096/1024", render_4096),
                      ("stereo locked PV session (x 2, NumPy in and out)",
                       stereo_session),
                      ("live: 200 reads of 1024 from a restart at 60 s",
                       live_reads)):
        k_ms = cuda_ms(fn)
        with plain_twins(*twins):
            p_ms = cuda_ms(fn)
        names, busy, wall = device_profile(fn)
        top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
        print(f"[22] {label} (180 s song): {k_ms:.2f} ms with the kernels, "
              f"{p_ms:.2f} ms all-plain; profiled: device busy {busy:.3f} ms "
              f"of {wall:.2f} ms wall (idle share {1.0 - busy / wall:.4f}); "
              f"device ms by name: "
              + ", ".join(f"{k[:48]} {v:.3f}" for k, v in top) + f" | {card}",
              flush=True)
    print(f"[22] B11 over the whole padded output ({pos_n.shape[0]} samples): "
          f"{b11_full_ms:.4f} ms | {card}", flush=True)

    print(card)  # the card's name and power limit, near the end again
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if len(sys.argv) > 1 else main())

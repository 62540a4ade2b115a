#!/usr/bin/env python3
"""Smoke run of melonix_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``melonix_tpu_torch/csrc`` and the
native host runtime from ``native/`` (``melonix_native.cpp`` and the FLAC,
MP3 and Vorbis decoders), holds each kernel
against its plain PyTorch twin on the card at the main paths' shapes, drives
the main paths once each on a 180 s, 44.1 kHz song with 12 markers (the
2048/512 |STFT| plus the phase-vocoder render; the granular export,
``render_track``; the Hann |STFT| pyramid at 2048/512 and 4096/1024 and
the waveform min/max pyramid; the spectrogram tile server's bursts and a
1280-column viewport; the pitch curve of the song and of a level-stepped
copy that puts 100 dB between adjacent frames (B8 also held per frame
against its twin on both); ``autotune`` with its
defaults, the formant-preserving phase vocoder, on a 180 s detuned melody;
the identity-locked render; renders at 4096/1024 (through B9) and 1000/250;
a locked stereo PV session; the streaming phase vocoder and the Player;
the file slice: the song through FLAC, the MP3 and Ogg fixtures, ``.mlx``
and ``.melonix`` projects into the CLI's ``render --rate 48000 --trace``,
granular ``render`` and ``batch --format flac``, ``resample`` alone under a
TF32 default, ``info`` and ``project``; the editor: the CLI's
``spectrogram`` of the song, default and ``--pyramid``, against the
all-plain scene, and an ``EditorServer`` on a 30 s excerpt: its frame loop
in four motions, the pitch overlay, 15 s of paced live playback through
HTTP on the PV engine beside a frame poller with a mid-stream edit, an
unpaced stream to the end, and ``/audio.wav`` on both engines),
checks their output (the granular export bit for bit against its plain
references and ``tests/oracle.py``, the columns against a float64 oracle,
the tiles against an all-plain server, the pitch curve against the song's
closed-form f0, the autotuned melody against its snapped notes, locked
phasiness against classic, each stereo channel against its mono render,
the stream against the offline render, the first buffer after an edit
against the bent pitch, each path against its all-plain run), shows that
each run went through every kernel of its path, and times kernels, twins,
one-PyTorch-call yardsticks and paths beside each kernel's bound (the
launch-bound kernels also as one CUDA graph, the device alone).  Any
failed check raises: the script then exits non-zero and prints no result.
The last line of standard output is

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


# Per 0.5 s segment: steps of 20 to 100 dB both ways, and silence
LEVELS = (1.0, 1e-2, 1e-3, 1e-5, 0.0, 1e-5, 1e-3, 1e-2, 1.0, 1e-5)


def make_level_steps(sr: int, seconds: float, hop: int) -> np.ndarray:
    """:func:`make_song` scaled per 0.5 s segment through ``LEVELS``, so
    that adjacent pitch frames differ by up to 100 dB and some are exactly
    silent; one hop shorter than ``seconds``, which gives the pitch path's
    frames of 2048 at a hop of 512 an odd count at 180 s."""
    x = make_song(sr, seconds)[: int(sr * seconds) - hop]
    t = np.arange(len(x)) / sr
    seg = np.asarray(LEVELS)[(t / 0.5).astype(np.int64) % len(LEVELS)]
    return (x * seg).astype(np.float32)


def per_frame_bar(ac_k, ac_p, w_p) -> tuple[float, bool, int]:
    """B8's per-frame bar: (the largest max_t |ac_k - ac_p| / (1e-5
    ac_p[f, 0]) over frames with ac_p[f, 0] > 0, which must be <= 1;
    whether ac_k is exactly 0 on every frame whose w_p is all zero; the
    count of those frames)."""
    live = ac_p[:, 0] > 0
    err = (ac_k[live].double() - ac_p[live].double()).abs().amax(dim=1)
    worst = float((err / (1e-5 * ac_p[live, 0].double())).max())
    silent = ~(w_p != 0).any(dim=1)
    return worst, bool((ac_k[silent] == 0).all()), int(silent.sum())


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


def graph_ms(fn, reps: int = REPS, inner: int = KERNEL_INNER) -> float:
    """Device time of one ``fn()``: ``inner`` calls back to back captured
    into one CUDA graph, replayed between two events (median of ``reps``
    after a warm-up replay), so the wrapper's host work is left out.  A
    capture that fails raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del graph
    return float(np.median(times))


@contextlib.contextmanager
def plain_twins(kpv, kres, krender, kcols, kstft, kpitch, kframes):
    """Route the main paths through the plain twins (for the all-plain
    reference runs on the card); restores the kernels on exit."""
    class PlainReader:
        """``kres.LerpReader``'s contract through B11's twin over the
        covering blocks (a stream built inside the context reads so)."""

        def __init__(self, y, pos, base, rows):
            self.ops = (y, pos, base, rows)

        def read(self, j, n):
            y, pos, base, rows = self.ops
            b0, b1 = j // kres.BLK, -(-(j + n) // kres.BLK)
            blk = kres.BLK
            got = kres.resample_lerp_plain(y, pos[b0 * blk : b1 * blk],
                                           base[b0:b1], rows)
            return got[j - b0 * blk : j + n - b0 * blk].cpu().numpy()

    saved = (kpv.stft_mag, kpv.analysis, kpv.synth_ola_phase,
             kres.resample_pv, krender.render_granular,
             kcols.spectrogram_columns_fused, kstft.stft_mag, kpitch.pitch_ac,
             kframes.extract_frames, kres.resample_lerp, kres.LerpReader)
    kframes.extract_frames = kframes.extract_frames_plain
    kres.resample_lerp = kres.resample_lerp_plain
    kres.LerpReader = PlainReader
    kpitch.pitch_ac = kpitch.pitch_ac_plain
    kcols.spectrogram_columns_fused = kcols.spectrogram_columns_plain
    kstft.stft_mag = kstft.stft_mag_plain
    kpv.stft_mag = kpv.stft_mag_plain
    kpv.analysis = kpv.analysis_plain
    kpv.synth_ola_phase = kpv.synth_ola_phase_plain
    kres.resample_pv = (
        lambda y, base, a0, cnt, *rest: kres.resample_pv_plain(y, base, *rest)
    )
    krender.render_granular = (
        lambda wav, gs, rate, sz, off, a0, cnt, out_len, szmax:
        krender.render_granular_plain(wav, gs, rate, sz, off, out_len, szmax)
    )
    try:
        yield
    finally:
        (kpv.stft_mag, kpv.analysis, kpv.synth_ola_phase,
         kres.resample_pv, krender.render_granular,
         kcols.spectrogram_columns_fused, kstft.stft_mag,
         kpitch.pitch_ac, kframes.extract_frames, kres.resample_lerp,
         kres.LerpReader) = saved


def load_oracle(root: str, name: str = "oracle"):
    """``tests/oracle.py`` (the literal transcription of the reference's
    render loop; NumPy only), or another NumPy-only helper of the tests
    (``scene_bars``), loaded by path without the test package."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "tests", f"{name}.py"))
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


def granular_edge_parity_max_err(mt, oracle, dev) -> float:
    """The 4 degenerate marker sets of ``tests/test_fuzz_parity.py`` (a
    marker at sample 0, two markers on one sample, a marker on the last
    sample, a time reversal) on its 0.8 s, 8 kHz signal (seed 77) through
    ``render_track`` on the card against ``oracle.export``; returns the max
    abs error over the four (each pair of lengths must agree)."""
    sr, rng = 8000, np.random.default_rng(77)
    t = np.arange(int(sr * 0.8)) / sr
    x = 0.5 * np.sin(2 * np.pi * (150 + 80 * rng.random()) * t)
    x += 0.2 * np.sin(2 * np.pi * (300 + 200 * rng.random()) * t
                      + rng.random())
    x += 0.02 * rng.standard_normal(len(t))
    x = x.astype(np.float32)
    n = len(x)
    M = mt.Marker
    cases = [
        [M(0, 50.0, 0.05, 2.0)],
        [M(n // 2, 50.0, 0.0, 0.0), M(n // 2, 55.0, 0.02, -1.0)],
        [M(n - 1, 50.0, 0.1, 3.0)],
        [M(n // 3, 50.0, -0.2, 1.0), M(2 * n // 3, 50.0, 0.15, -2.0)],
    ]
    table = mt.build_grain_table(x)
    grains = list(zip(table.starts.tolist(), table.lengths.tolist()))
    worst = 0.0
    for i, ms in enumerate(cases):
        ms = mt.sort_markers(ms)
        got = mt.render_track(x, table, mt.MapKnots.from_markers(ms, sr, n),
                              device=dev)
        want = oracle.export(x, grains, [(m.sample, m.note, m.d_time,
                                          m.pitch_bend) for m in ms], sr)
        check(got.shape == want.shape,
              f"edge set {i}: lengths {got.shape} {want.shape}")
        worst = max(worst, float(np.max(np.abs(got - want))))
    return worst


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
    """One rank of phase 20's gloo group on the card or of phase 27's NCCL
    group over every card (the parent runs ``chip_smoke.py --rank R --world
    W --port P --out DIR [--backend nccl]`` per rank): the sequence-parallel
    PV of the song on a (1, W) mesh, the batch of four jobs and a stereo
    session on a (W, 1) mesh and, on NCCL where W is even and at least 4, on
    a (2, W / 2) mesh.  Under gloo every rank computes on cuda:0 and the
    payloads go through host memory; under NCCL rank R joins the group
    through ``join_group`` with the launcher's environment and computes on
    cuda:R.  Writes its numbers and rank 0's reference checks to DIR."""
    import argparse

    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.kernels import pv as kpv
    from melonix_tpu_torch.kernels import resample as kres
    from melonix_tpu_torch.utils import Timer, registry

    if a.backend == "nccl":
        os.environ.update(RANK=str(a.rank), LOCAL_RANK=str(a.rank),
                          WORLD_SIZE=str(a.world), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(a.port))
        dev = mt.join_group("cuda")
    else:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{a.port}",
                                world_size=a.world, rank=a.rank)
    seq_mesh = mt.make_audio_mesh(a.world, data=1)
    meshes = [("", mt.make_audio_mesh(a.world, data=a.world))]
    if a.backend == "nccl" and a.world % 2 == 0 and a.world >= 4:
        meshes.append((f"_2x{a.world // 2}", mt.make_audio_mesh(a.world,
                                                                data=2)))
    # every group's communicator formed before anything is timed (NCCL
    # forms one at a group's first collective), the set-up timed alone;
    # every rank walks its own groups in the same order
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m in [seq_mesh] + [mesh for _tag, mesh in meshes]:
        for g, size in ((m.seq, m.shape["seq"]), (m.data, m.shape["data"])):
            one = torch.zeros(1, device=dev if a.backend == "nccl"
                              else "cpu")
            dist.all_gather([torch.empty_like(one) for _ in range(size)], one,
                            group=g)
    torch.cuda.synchronize()
    groups_ms = 1e3 * (time.perf_counter() - t0)
    x = make_song(SR, SECONDS)
    markers = bench_markers(mt, len(x))
    gather = registry("parallel.gather", Timer)
    sent = registry("parallel.gather_bytes")
    counters = (kpv.analysis, kpv.synth_ola, kpv.synth_ola_phase,
                kres.resample_pv)
    res = {"rank": a.rank, "device": str(dev), "backend": a.backend,
           "kind": torch.cuda.get_device_name(dev), "groups_ms": groups_ms,
           "meshes": [m[0] for m in meshes]}

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
        res[label]["profile"] = {
            "busy_ms": busy, "wall_ms": wall,
            "top": [[k[:48], v] for k, v in top],
            "nccl_ms": sum(v for k, v in names.items() if "nccl" in k.lower())}
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
        "device": str(y.device),
        "snr_db": float(10.0 * torch.log10(
            err.clamp_min(1e-300) / want.double().square().sum())),
        "max_abs_err": float((y - want).abs().max())}
    del seen, mag, psi, y, want
    out = run("seq_pv", seq_pv)
    np.save(os.path.join(a.out, f"seq_pv_rank{a.rank}.npy"), out)

    tracks, ms_l = batch_jobs(mt, x)
    st = np.ascontiguousarray(np.stack([x, 0.8 * x[::-1]], axis=1),
                              dtype=np.float32)
    refs = {}  # rank 0's single-device renders, made once for every mesh
    for tag, mesh in meshes:
        for engine in ("granular", "pv"):
            outs = run(f"batch_{engine}{tag}", lambda: mt.render_batch(
                tracks, ms_l, SR, engine=engine, mesh=mesh))
            if a.rank == 0:
                errs = []
                for j, (t, ms, o) in enumerate(zip(tracks, ms_l, outs)):
                    if (engine, j) not in refs:
                        refs[engine, j] = mt.render_session(
                            t, ms, SR, engine=engine, mesh=None)
                    want = refs[engine, j]
                    same_len = o.shape == want.shape
                    if engine == "granular":
                        errs.append([same_len, float(np.abs(o - want).max()),
                                     bool(np.array_equal(o == 0.0,
                                                         want == 0.0))])
                    else:
                        errs.append([same_len, snr_np(o, want)])
                res[f"batch_{engine}{tag}"]["vs_render_session"] = errs
        for engine in ("granular", "pv"):
            got = run(f"stereo_{engine}{tag}", lambda: mt.render_session(
                st, markers, SR, engine=engine, mesh=mesh))
            if a.rank == 0:
                if ("stereo", engine) not in refs:
                    refs["stereo", engine] = mt.render_session(
                        st, markers, SR, engine=engine, mesh=None)
                want = refs["stereo", engine]
                res[f"stereo_{engine}{tag}"]["vs_no_mesh"] = [
                    got.shape == want.shape, float(np.abs(got - want).max()),
                    bool(np.array_equal(got == 0.0, want == 0.0))]
    with open(os.path.join(a.out, f"rank{a.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_ranks(world: int, backend: str, timeout: float = 420):
    """Phase 20's or 27's ranks (:func:`rank_main`), one process each, on a
    free local port: (each rank's numbers, each rank's seq-parallel PV)."""
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.closing(socket.socket()) as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--port", str(port), "--out", tmp,
             "--backend", backend])
            for r in range(world)]
        try:
            codes = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(codes == [0] * world, f"{backend} ranks exited {codes}")
        rk = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                rk.append(json.load(f))
        seq_out = [np.load(os.path.join(tmp, f"seq_pv_rank{r}.npy"))
                   for r in range(world)]
    return rk, seq_out


def rank_checks(tag: str, rk, seq_out, want, exact, card: str, where: str,
                beside=None) -> None:
    """Phase 20's and 27's bars on the ranks' results: the seq-parallel PV
    against the exact phase sum and the single render ``want`` (every rank
    returning the whole track), B10 on each rank's own operands against its
    twin, each rank's launches, and the batch and stereo renders on every
    mesh against the single-device renders; each rank's wall and gathers
    printed (``beside``: phase 20's gloo ranks, printed next to them)."""
    import torch

    world = len(rk)
    rms_x, env_x = rms_rel_env(seq_out[0], exact, SR)
    rms_s, env_s = rms_env(torch.from_numpy(seq_out[0]),
                           torch.from_numpy(want))
    rms_q, env_q = rms_rel_env(seq_out[0], want, SR)
    same_ranks = all(np.array_equal(o, seq_out[0]) for o in seq_out)
    print(f"{tag} seq-parallel PV of the {SECONDS:.0f} s song on {world} "
          f"{where} (data=1, seq={world}): vs the exact phase sum rms "
          f"{rms_x:.3e} of rms (bar 2e-3), envelope {env_x:.3e} (bar 2e-2); "
          f"vs render_track_pv rms {rms_s:.3e} of max (bar 2e-3), envelope "
          f"{env_s:.3e} (bar 2e-2), quarter-second form rms {rms_q:.3e} of "
          f"rms, envelope {env_q:.3e}; every rank returns the whole track, "
          f"equal {same_ranks}", flush=True)

    def nccl(q):
        """NCCL's kernels in the profiled run: the gathers on the device,
        waits for the slowest rank included (the host timer holds only
        their queueing)."""
        if "nccl_ms" not in q["profile"] or not q["profile"]["nccl_ms"]:
            return ""
        return f", NCCL kernels {q['profile']['nccl_ms']:.2f} ms on the device"

    def old(r, label):
        if beside is None or r >= len(beside) or label not in beside[r]:
            return ""
        q = beside[r][label]
        return (f" (phase 20, gloo on one card: wall {q['wall_ms']:.2f} ms, "
                f"gathers {q['gather_ms']:.2f} ms)")

    for r in rk:
        b = r["b10_vs_twin"]
        print(f"     rank {r['rank']} on {r['device']}: B10 on its own "
              f"operands ({b['frames']} frames, {b['live']} live, |psi| up "
              f"to {b['max_abs_psi']:.4g}, on {b['device']}) vs its twin: "
              f"SNR {b['snr_db']:.1f} dB (bar < -100), max abs err "
              f"{b['max_abs_err']:.3e}", flush=True)
        check(b["same_shape"] and b["snr_db"] < -100.0
              and b["device"] == r["device"],
              f"rank {r['rank']}: B10 vs twin on the seq path's operands")
        q = r["seq_pv"]
        print(f"     rank {r['rank']}: its {len(r['meshes']) + 1} meshes' "
              f"groups formed (one all-gather each) in "
              f"{r['groups_ms']:.1f} ms before any timing", flush=True)
        print(f"     rank {r['rank']}: wall {q['wall_ms']:.2f} ms, of it "
              f"{q['gathers']} {r['backend']} all-gathers "
              f"{q['gather_ms']:.2f} ms on the host"
              f"{nccl(q)} ({q['gather_bytes'] / 2**20:.1f} MiB "
              f"sent){old(r['rank'], 'seq_pv')}; launches {q['launches']} "
              f"(bars: B2 1, B10 1, B3 0) | {card}", flush=True)
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
    check(rms_s < 2e-3 and env_s < 2e-2, "seq-parallel PV vs single")
    r0 = rk[0]
    for mtag in r0["meshes"]:
        shape = (f"data={world}, seq=1" if not mtag
                 else f"data=2, seq={world // 2}")
        g = r0[f"batch_granular{mtag}"]["vs_render_session"]
        p = r0[f"batch_pv{mtag}"]["vs_render_session"]
        for engine in ("granular", "pv"):
            for r in rk:
                q = r[f"batch_{engine}{mtag}"]
                pr = q["profile"]
                print(f"     render_batch of 4 jobs, {engine}, ({shape}), "
                      f"rank {r['rank']}: wall {q['wall_ms']:.2f} ms, "
                      f"gathers {q['gather_ms']:.2f} ms on the host"
                      f"{nccl(q)} ({q['gather_bytes'] / 2**20:.1f} MiB)"
                      f"{old(r['rank'], f'batch_{engine}' + mtag)}; launches "
                      f"{q['launches']}; device busy {pr['busy_ms']:.3f} ms "
                      f"of {pr['wall_ms']:.2f} ms profiled (idle share "
                      f"{1.0 - pr['busy_ms'] / pr['wall_ms']:.4f}) | {card}",
                      flush=True)
        print(f"     batch ({shape}) vs per-job render_session: granular "
              f"[len ok, max err, zeros equal] {g} (bar 2e-6); pv [len ok, "
              f"SNR dB] {p} (bar < -60)", flush=True)
        check(all(a and e <= 2e-6 and z for a, e, z in g)
              and all(a and v < -60.0 for a, v in p),
              f"render_batch on {world} ranks ({shape}) vs render_session")
        for engine in ("granular", "pv"):
            ok, e, z = r0[f"stereo_{engine}{mtag}"]["vs_no_mesh"]
            q = r0[f"stereo_{engine}{mtag}"]
            print(f"     stereo {engine} session, channels over data "
                  f"({shape}): vs mesh=None max err {e:.3e} (bar "
                  f"{'2e-6' if engine == 'granular' else 'equal'}), zeros "
                  f"equal {z}; rank 0 wall {q['wall_ms']:.2f} ms"
                  f"{old(0, f'stereo_{engine}' + mtag)}", flush=True)
            check(ok and z and (e <= 2e-6 if engine == "granular"
                                else e == 0.0),
                  f"stereo {engine} session over data ({shape})")


def cli_batch_takes(mt, x: np.ndarray, tmp: str) -> None:
    """Phase 21's CLI half: three 20 s takes of the song (float32 WAVs) and
    the first four bench markers written to ``tmp``, the CLI's ``batch``
    (pv with formants, the default; one process) into
    ``tmp/out21``, held bit for bit to a per-file ``render --engine pv
    --formant`` of each (``tmp/one{i}.wav``); phase 27 reuses all of it."""
    from melonix_tpu_torch.cli import main as cli_main

    for i in range(3):
        mt.write_wav(os.path.join(tmp, f"take{i}.wav"),
                     x[i * 20 * SR : (i + 1) * 20 * SR], SR, dtype="float32")
    mjson = os.path.join(tmp, "m.json")
    with open(mjson, "w") as f:
        f.write(mt.markers_to_json(bench_markers(mt, 20 * SR)[:4]))
    outdir = os.path.join(tmp, "out21")
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


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def one_card_pair(root: str, takes: str) -> None:
    """Two NCCL ranks on one card (``CUDA_VISIBLE_DEVICES`` of one card):
    ``launch`` of the CLI's ``batch`` must exit non-zero within 60 s with
    the port's own ``rank_device`` error, not NCCL's and not a hang.  The
    launch's own 60 s timeout stops the ranks of a hang (the 90 s kill of
    this process's session is the last resort)."""
    import signal

    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    code = (f"import sys; sys.path.insert(0, {root!r}); "
            "from melonix_tpu_torch.parallel.launch import launch; "
            f"sys.exit(launch(['batch', {os.path.join(takes, 'take*.wav')!r},"
            f" '-o', {os.path.join(takes, 'pair')!r}, '--device', 'cuda'], 2,"
            " timeout=60))")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code],
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=visible),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        text = proc.communicate(timeout=90)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text = proc.communicate()[0] + "\n[killed after 90 s]"
    dt = time.perf_counter() - t0
    ours = "RankDeviceError" in text and "asks for cuda:1" in text
    lines = [ln for ln in text.splitlines() if "RankDeviceError" in ln]
    print(f"[27] two NCCL ranks under CUDA_VISIBLE_DEVICES={visible}: exit "
          f"{proc.returncode} after {dt:.1f} s (bar: non-zero within 60 s), "
          f"the port's own error {ours}: {lines[-1] if lines else text[-400:]}",
          flush=True)
    check(proc.returncode not in (0, None) and dt < 60.0 and ours,
          "two NCCL ranks on one card refused by rank_device")


def b2_shard_split(mt, x: np.ndarray, n_shards: int,
                   device="cuda") -> tuple[float, int]:
    """B2 on the seq-parallel PV's padded frames of the song in one call
    against the same frames in ``n_shards`` consecutive calls, as the seq
    ranks run it: (max |difference| of (re, im) over max |re, im|, frames a
    shard); 0.0 when no frame's result depends on how the frames are
    split."""
    import torch

    from melonix_tpu_torch.engine import phase_vocoder as pv
    from melonix_tpu_torch.engine.spectral import hann_window
    from melonix_tpu_torch.kernels import pv as kpv
    from melonix_tpu_torch.parallel import sharded

    plan = pv.build_pv_plan(mt.MapKnots.from_markers(
        bench_markers(mt, len(x)), SR, len(x)), len(x))
    kw, ops = sharded.seq_pv_args(plan, n_shards)
    f = kw["n_frames"] // n_shards
    wav = torch.from_numpy(x).to(device)
    win = torch.from_numpy(hann_window(kw["size"])).to(device)
    st = torch.from_numpy(np.asarray(ops[0], np.int32)).to(device)
    whole = torch.stack(kpv.analysis(wav, st, win, kw["size"]))
    parts = [kpv.analysis(wav, st[i * f:(i + 1) * f].contiguous(), win,
                          kw["size"]) for i in range(n_shards)]
    split = torch.stack([torch.cat([p[j] for p in parts]) for j in (0, 1)])
    return float((whole - split).abs().max() / whole.abs().max()), f


def spawn_breakdown(root: str) -> dict:
    """What a rank pays before its first render, in one fresh process
    timed step by step (ms): the interpreter to its first line, ``import
    torch``, ``import melonix_tpu_torch``, the CUDA context (a first
    tensor on the card), an NCCL group of one (formed and a barrier
    passed), the kernel library's load (built already), and the exit."""
    with contextlib.closing(socket.socket()) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = f"""
import time
t = [time.perf_counter()]
import datetime, json, sys
import torch
t.append(time.perf_counter())
sys.path.insert(0, {root!r})
import melonix_tpu_torch
t.append(time.perf_counter())
torch.cuda.set_device(0)
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t.append(time.perf_counter())
import torch.distributed as dist
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:{port}",
                        rank=0, world_size=1,
                        device_id=torch.device("cuda", 0),
                        timeout=datetime.timedelta(seconds=60))
dist.barrier()
torch.cuda.synchronize()
t.append(time.perf_counter())
from melonix_tpu_torch.kernels import _build
_build.library()
t.append(time.perf_counter())
dist.destroy_process_group()
print(json.dumps([b - a for a, b in zip(t, t[1:])]))
"""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"spawn breakdown: {proc.stderr[-2000:]}")
    steps = json.loads(proc.stdout.strip().splitlines()[-1])
    names = ("torch_import", "melonix_import", "cuda_context", "nccl_group",
             "library_load")
    out = {k: 1e3 * v for k, v in zip(names, steps)}
    out["start_and_exit"] = 1e3 * wall - sum(out.values())
    out["wall"] = 1e3 * wall
    return out


def every_card_phase(mt, x: np.ndarray, card: str, root: str, takes: str,
                     want: np.ndarray, exact: np.ndarray,
                     rk20=None) -> None:
    """Phase 27: the port on every card.  The cards and their power limits;
    the launcher's spawn-to-first-render time (``launch`` of a one-rank
    ``render`` against the same render in this process); the CLI's
    ``batch`` through ``launch`` over every visible card on phase 21's
    takes, ``--engine pv`` (formants, the default) and ``--engine
    granular``, each file held to the per-file render (one card: one NCCL
    rank, bit for bit phase 21's files and the per-file renders; more: PV
    SNR < -60 dB against ``render_session``, granular within one int16
    step of the per-file render's file); two NCCL ranks on one card refused
    by the port; and, with two cards or more, phase 20's cases on one NCCL
    rank a card at phase 20's bars (:func:`rank_checks`)."""
    import torch

    from melonix_tpu_torch.cli import main as cli_main
    from melonix_tpu_torch.parallel.launch import launch

    n_cards = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(f"[27] torch.cuda.device_count() {n_cards}; cards: "
          + "; ".join(f"{i}: {ln}" for i, ln in enumerate(smi)), flush=True)
    glob = os.path.join(takes, "take*.wav")
    mjson = os.path.join(takes, "m.json")
    take0 = os.path.join(takes, "take0.wav")

    # the spawn: a process, its CUDA context, the library load, one render
    args = ["render", take0, "--markers", mjson, "--engine", "pv",
            "--formant"]
    t0 = time.perf_counter()
    rc = launch(args + ["-o", os.path.join(takes, "spawned.wav")], 1)
    spawn_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    check(cli_main(args + ["-o", os.path.join(takes, "here.wav")]) == 0,
          "CLI render")
    here_ms = 1e3 * (time.perf_counter() - t0)
    same = file_bytes(os.path.join(takes, "spawned.wav")) == file_bytes(
        os.path.join(takes, "here.wav")) if rc == 0 else False
    print(f"[27] launch of a one-rank render (20 s take, pv with formants; "
          f"spawn, imports, CUDA context, library load, render, write): "
          f"{spawn_ms:.1f} ms; the same render in this warm process "
          f"{here_ms:.1f} ms; the spawn's cost {spawn_ms - here_ms:.1f} ms; "
          f"files equal {same} | {card}", flush=True)
    check(rc == 0 and same, f"launched render rc {rc}, equal {same}")
    parts = spawn_breakdown(root)
    print("[27] a fresh rank before its first render, ms: "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f" | {card}", flush=True)

    for engine in ("pv", "granular"):
        outdir = os.path.join(takes, f"out27_{engine}")
        t0 = time.perf_counter()
        rc = launch(["batch", glob, "--markers", mjson, "--engine", engine,
                     "-o", outdir], n_cards)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        check(rc == 0, f"launched batch ({engine}) rc {rc}")
        errs = []
        for i in range(3):
            name = f"take{i}.wav"
            got = os.path.join(outdir, name)
            if engine == "pv":
                ref = os.path.join(takes, "out21", name)
            else:
                ref = os.path.join(takes, f"one{i}_granular.wav")
                check(cli_main(["render", os.path.join(takes, name),
                                "--markers", mjson, "--engine", "granular",
                                "-o", ref]) == 0, "CLI render (granular)")
            a_, _r = mt.read_wav(got)
            b_, _r = mt.read_wav(ref)
            if n_cards == 1:
                errs.append(file_bytes(got) == file_bytes(ref))
            elif engine == "pv":
                t_, _r = mt.read_wav(os.path.join(takes, name))
                want_i = mt.render_session(
                    t_, mt.markers_from_json(file_bytes(mjson).decode()), SR,
                    engine="pv", preserve_formants=True, mesh=None)
                errs.append(a_.shape == want_i.shape
                            and snr_np(a_, want_i) < -60.0)
            else:
                errs.append(a_.shape == b_.shape and float(
                    np.abs(a_ - b_).max()) <= 1.01 / 32767)
        bar = ("bit for bit phase 21's files" if engine == "pv"
               else "bit for bit the per-file render") if n_cards == 1 else (
            "SNR < -60 dB vs render_session" if engine == "pv"
            else "one int16 step of the per-file render")
        print(f"[27] CLI batch of 3 WAVs ({engine}) through launch over "
              f"{n_cards} card(s) ({n_cards} NCCL rank(s)): {wall_ms:.1f} ms "
              f"wall from the launch to the last rank's exit; each file "
              f"{bar}: {errs} | {card}", flush=True)
        check(all(errs), f"launched batch ({engine}) vs per-file renders")

    one_card_pair(root, takes)

    if n_cards < 2:
        print("[27] the cases across cards (phase 20's seq-parallel PV on "
              "(1, n), render_batch and the stereo session on (n, 1) and "
              "(2, n / 2), B10 on each rank's operands, one NCCL rank a "
              "card) did not run: this machine has one card", flush=True)
        return
    for shards in sorted({2, n_cards}):
        diff, f = b2_shard_split(mt, x, shards)
        print(f"[27] B2 on the seq PV's frames in {shards} calls of {f} "
              f"frames vs one call: max diff {diff:.3e} of max", flush=True)
    rk, seq_out = run_ranks(n_cards, "nccl", timeout=600)
    rank_checks("[27]", rk, seq_out, want, exact, card,
                "NCCL ranks (one a card, payloads on the cards)", beside=rk20)


def synth_ptxas(log: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, stack bytes) of the pair
    synthesis kernels in an nvcc log with ptxas -v: the mode is the
    template argument (0 B3's half spectrum, 1 locked, 2 B10's polar)."""
    import re

    modes = {"0": "half", "1": "locked", "2": "polar"}
    out, name, stack, spill = [], None, 0, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"synth_pair_kernelILi(\d)E", m.group(1))
            unit = re.search(r"_(pv_synth_ola(?:_phase)?)_cu", m.group(1))
            name = (f"synth_pair_kernel<{modes[k.group(1)]}> "
                    f"({unit.group(1)}.cu)" if k and unit else None)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill, stack))
            name = None
    return out


def polyphase_f64(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """The port's resampler evaluated in float64 NumPy on the same float32
    banks: the reference its float32 device products are held to."""
    from melonix_tpu_torch.io import resample as rs

    up, down, n_out, m_out, rows, banks, front = rs.plan(len(x), sr_in,
                                                         sr_out)
    xp = np.zeros(rows * down)
    xp[front * down : front * down + len(x)] = x
    x2 = xp.reshape(rows, down)
    acc = sum(x2[r : r + m_out] @ banks[r].astype(np.float64)
              for r in range(banks.shape[0]))
    return acc.reshape(-1)[:n_out]


def file_slice(mt, x: np.ndarray, card: str, root: str) -> None:
    """Phase 23: the song through FLAC, MP3 and Ogg import, ``.mlx`` and
    ``.melonix`` projects, the CLI's ``render --rate --trace``, granular
    render and ``batch --format flac`` from files, ``resample`` alone under
    a TF32 default, ``info`` and ``project``.  Every check raises."""
    import glob
    import io as _io
    import torch

    from melonix_tpu_torch.cli import main as cli_main
    from melonix_tpu_torch.io import libav
    from melonix_tpu_torch.io import resample as rs
    from melonix_tpu_torch.io.melonix import load_melonix, save_melonix
    from melonix_tpu_torch.kernels import pv as kpv
    from melonix_tpu_torch.kernels import render as krender
    from melonix_tpu_torch.kernels import resample as kres
    from melonix_tpu_torch.runtime import native

    n = len(x)
    markers = bench_markers(mt, n)
    with tempfile.TemporaryDirectory() as tmp:
        # -- encode, decode, save ------------------------------------
        song = os.path.join(tmp, "song.flac")
        t0 = time.perf_counter()
        mt.write_flac(song, x, SR)
        enc_ms = 1e3 * (time.perf_counter() - t0)
        calls = native.decode_flac.calls
        t0 = time.perf_counter()
        y, rate = mt.load_audio(song)
        dec_ms = 1e3 * (time.perf_counter() - t0)
        q = (np.clip(np.rint(x * 32768.0), -32768, 32767) / 32768.0).astype(
            np.float32)
        same = rate == SR and np.array_equal(y, q)
        print(f"[23] FLAC of the {SECONDS:.0f} s song ({os.path.getsize(song)} "
              f"bytes): write_flac {enc_ms:.1f} ms, load_audio {dec_ms:.1f} ms "
              f"host; equal to the int16-quantised song {same} (bar: equal)",
              flush=True)
        check(same and native.decode_flac.calls == calls + 1, "FLAC decode")
        for path in sorted(glob.glob(os.path.join(root, "tests", "fixtures",
                                                  "*"))):
            t0 = time.perf_counter()
            a, r = mt.load_audio(path, mono=False)
            ms = 1e3 * (time.perf_counter() - t0)
            ok = r > 0 and a.shape[0] > 0 and bool(np.isfinite(a).all())
            print(f"     {os.path.basename(path)}: {a.shape} at {r} Hz in "
                  f"{ms:.2f} ms host, finite {ok}", flush=True)
            check(ok, f"decode of {path}")
        shim = libav.try_load()
        print("     libav shim: " + ("built, not used by this phase"
                                      if shim is not None else
                                      f"absent ({libav.build_error.splitlines()[0]})"),
              flush=True)
        proj = mt.Project(wav=x, sample_rate=SR, markers=markers)
        mlx = mt.save_project(os.path.join(tmp, "song.mlx"), proj)
        mel = save_melonix(os.path.join(tmp, "song.melonix"), proj)

        # -- render song.mlx --engine pv --rate 48000 --trace ----------
        pv_fns = (kpv.analysis, kpv.synth_ola_phase, kres.resample_pv)
        for fn in pv_fns:
            fn.launches = 0
        out48, tr = os.path.join(tmp, "out.wav"), os.path.join(tmp, "tr")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(cli_main(["render", mlx, "--engine", "pv", "--rate", "48000",
                        "--trace", tr, "-o", out48, "--dtype", "float32"]) == 0,
              "CLI render --rate --trace")
        wall = 1e3 * (time.perf_counter() - t0)
        launched = {fn.__name__: fn.launches for fn in pv_fns}
        got, got_rate = mt.read_wav(out48)
        ref = mt.render_session(x, markers, SR, engine="pv")
        want = polyphase_f64(ref.astype(np.float64), SR, 48000)
        rms, env = rms_env(torch.from_numpy(got.astype(np.float64)),
                           torch.from_numpy(want))
        print(f"[23] CLI render song.mlx --engine pv --rate 48000 --trace: "
              f"{wall:.1f} ms wall (load, render, resample, trace export, "
              f"write); launches {launched}; {got.shape[0]} samples at "
              f"{got_rate} Hz; vs render_session + float64 polyphase: rms "
              f"{rms:.2e} (bar 5e-3 of peak), envelope {env:.2e} (bar 2e-2)"
              f" | {card}", flush=True)
        check(all(v > 0 for v in launched.values()), "PV kernels not launched")
        check(got_rate == 48000 and got.shape == want.shape, "48 kHz output")
        check(rms < 5e-3 and env < 2e-2, "render --rate vs reference")
        (trace_file,) = os.listdir(tr)
        with open(os.path.join(tr, trace_file)) as f:
            events = json.load(f)["traceEvents"]
        kernels: dict = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "kernel":
                kernels[e["name"]] = kernels.get(e["name"], 0) + 1
        top = sorted(kernels.items(), key=lambda kv: -kv[1])
        print(f"     trace {trace_file}: {len(events)} events, "
              f"{sum(kernels.values())} CUDA kernel events: "
              + (", ".join(f"{k[:48]} x{v}" for k, v in top) or "none"),
              flush=True)

        # -- granular render of song.melonix; batch --format flac ------
        krender.render_granular.launches = 0
        gout = os.path.join(tmp, "g.wav")
        check(cli_main(["render", mel, "-o", gout, "--dtype", "float32"]) == 0,
              "CLI render of .melonix")
        g_launches = krender.render_granular.launches
        back = load_melonix(mel)
        want_g = mt.render_track(
            back.wav, mt.build_grain_table(back.wav),
            mt.MapKnots.from_markers(back.markers, back.sample_rate,
                                     len(back.wav)), device="cpu")
        got_g, _r = mt.read_wav(gout)
        same = bool(np.array_equal(got_g, want_g))
        print(f"     CLI render song.melonix (granular): B5 + B6 launches "
              f"{g_launches}; equal to render_track on the CPU {same} (bar: "
              f"equal)", flush=True)
        check(g_launches > 0 and same, "granular render of .melonix")
        mjson = os.path.join(tmp, "m.json")
        with open(mjson, "w") as f:
            f.write(mt.markers_to_json(bench_markers(mt, 20 * SR)[:4]))
        for i in range(3):
            mt.write_flac(os.path.join(tmp, f"take{i}.flac"),
                          x[i * 20 * SR : (i + 1) * 20 * SR], SR)
        outdir = os.path.join(tmp, "batch")
        check(cli_main(["batch", os.path.join(tmp, "take*.flac"), "--markers",
                        mjson, "--format", "flac", "-o", outdir]) == 0,
              "CLI batch --format flac")
        steps = []
        for i in range(3):
            one = os.path.join(tmp, f"one{i}.wav")
            check(cli_main(["render", os.path.join(tmp, f"take{i}.flac"),
                            "--markers", mjson, "--engine", "pv", "--formant",
                            "--dtype", "float32", "-o", one]) == 0,
                  "CLI render of a FLAC")
            a_, _r = mt.load_audio(os.path.join(outdir, f"take{i}.flac"))
            b_, _r = mt.read_wav(one)
            steps.append(float(np.abs(a_ - b_).max()) * 32767
                         if a_.shape == b_.shape else float("inf"))
        print(f"     CLI batch of 3 FLAC takes --format flac (pv with "
              f"formants) vs per-file render to float32 WAV: max diff in "
              f"int16 steps "
              f"{['%.3f' % v for v in steps]} (bar 1.01)", flush=True)
        check(all(v <= 1.01 for v in steps), "batch --format flac vs render")

        # -- resample alone, TF32 the process default ----------------
        saved = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            for sr_in, sr_out in ((44100, 48000), (48000, 44100),
                                  (44100, 16000)):
                got = rs.resample(x, sr_in, sr_out)
                check(torch.get_float32_matmul_precision() == "high",
                      "resample restores the caller's precision")
                want = polyphase_f64(x.astype(np.float64), sr_in, sr_out)
                snr = snr_np(got, want)
                up, down, n_out, m_out, rows, banks, front = rs.plan(
                    n, sr_in, sr_out)
                x2 = torch.zeros(1, rows, down, device="cuda")
                x2.view(-1)[front * down : front * down + n] = \
                    torch.from_numpy(x).cuda()
                hb = torch.from_numpy(banks).cuda()
                tf32 = rs._polyphase_device(x2, hb, m_out)  # under "high"
                tf32_snr = snr_np(tf32.cpu().numpy().reshape(-1)[:n_out],
                                  want)
                call_ms = cuda_ms(lambda: rs.resample(x, sr_in, sr_out),
                                  inner=KERNEL_INNER)
                with rs.ieee_float32():
                    dev_ms = graph_ms(lambda: rs._polyphase_device(x2, hb,
                                                                   m_out))
                flops = 2.0 * m_out * down * up * banks.shape[0]
                b_ms, b_by = bound(nbytes(x2) + 4 * m_out * up, flops)
                print(f"[23] resample {sr_in} -> {sr_out} of the song "
                      f"(banks {tuple(banks.shape)}, {m_out} rows): SNR "
                      f"{snr:.1f} dB vs float64 (bar -100; the same products "
                      f"in TF32 {tf32_snr:.1f} dB); {call_ms:.4f} ms a call "
                      f"with upload and download, device product alone "
                      f"(one CUDA graph) {dev_ms:.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}, {flops / 1e9:.2f} GFLOP) | {card}",
                      flush=True)
                check(snr < -100.0, f"resample {sr_in}->{sr_out} SNR {snr}")
                del x2, hb, tf32
        finally:
            torch.set_float32_matmul_precision(saved)

        # -- info and project ----------------------------------------
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli_main(["info", mlx]) == 0, "CLI info")
        info = json.loads(buf.getvalue())
        warped = round(mt.MapKnots.from_markers(markers, SR, n).duration(), 3)
        again = os.path.join(tmp, "again.mlx")
        check(cli_main(["project", mlx, "-o", again]) == 0, "CLI project")
        with open(mlx, "rb") as f1, open(again, "rb") as f2:
            same = f1.read() == f2.read()
        print(f"[23] CLI info song.mlx: samples {info['samples']}, rate "
              f"{info['sample_rate']}, markers {info['markers']}, warped "
              f"{info['warped_duration_sec']} s (want {n}, {SR}, 12, "
              f"{warped}); project round trip byte-identical {same}",
              flush=True)
        check(info["samples"] == n and info["sample_rate"] == SR
              and info["markers"] == 12
              and info["warped_duration_sec"] == warped and same,
              "CLI info / project")


# ----------------------------------------------------------------------
# Phase 24: the editor (ui/state.py, view.py, web.py; the CLI's
# spectrogram and ui)
# ----------------------------------------------------------------------

UI_FRAME = "/frame.png?fmt=jpg&w=1280&h=720"


class TimedLock:
    """An ``RLock`` that records how long each outermost hold lasted (ms),
    by the holder's function and, in an HTTP handler, its path (the editor
    server's lock, swapped in before the server starts)."""

    def __init__(self):
        import threading

        self._lock = threading.RLock()
        self._local = threading.local()
        self.holds: dict = {}

    def acquire(self, *a, **kw):
        got = self._lock.acquire(*a, **kw)
        if got:
            depth = getattr(self._local, "depth", 0)
            if depth == 0:
                f = sys._getframe(2)  # the caller of ``with lock:``
                label = f.f_code.co_name
                if label == "do_GET":
                    label += " " + f.f_locals["u"].path
                elif label == "do_POST":
                    label += " " + f.f_locals["self"].path
                self._local.t0, self._local.label = time.perf_counter(), label
            self._local.depth = depth + 1
        return got

    def release(self):
        self._local.depth -= 1
        if self._local.depth == 0:
            ms = 1e3 * (time.perf_counter() - self._local.t0)
            self.holds.setdefault(self._local.label, []).append(ms)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class UiClient:
    """One keep-alive HTTP connection to the editor server."""

    def __init__(self, port: int, timeout: float = 60.0):
        import http.client

        self.port = port
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=timeout)

    def get(self, path: str):
        self.conn.request("GET", path)
        r = self.conn.getresponse()
        body = r.read()
        check(r.status == 200, f"GET {path}: {r.status} {body[:200]!r}")
        return body, r.getheader("Content-Type")

    def post(self, path: str, obj) -> dict:
        self.conn.request("POST", path, json.dumps(obj),
                          {"Content-Type": "application/json"})
        r = self.conn.getresponse()
        body = r.read()
        check(r.status == 200, f"POST {path} {obj}: {r.status} {body[:200]!r}")
        return json.loads(body)

    def state(self) -> dict:
        return json.loads(self.get("/state")[0])

    def close(self) -> None:
        self.conn.close()


def ui_settle(cl: UiClient, limit_s: float = 120.0) -> float:
    """Poll /state until no tile is pending or in flight; the wait in ms."""
    t0 = time.perf_counter()
    while True:
        tl = cl.state()["tiles"]
        if tl["pending"] == 0 and tl.get("inflight", 0) == 0:
            return 1e3 * (time.perf_counter() - t0)
        check(time.perf_counter() - t0 < limit_s, f"tiles never settled: {tl}")
        time.sleep(0.005)


def ui_fps(cl: UiClient, seconds: float, event=None) -> tuple[float, str]:
    """Frames a second of the /frame.png loop at 1280x720 over local HTTP
    (bench.py:_ui_fps), with ``event`` posted before each frame."""
    t0 = time.perf_counter()
    frames, mime = 0, None
    while time.perf_counter() - t0 < seconds:
        if event is not None:
            cl.post("/event", event)
        _body, mime = cl.get(UI_FRAME)
        frames += 1
    return frames / (time.perf_counter() - t0), mime


def live_http(port: int, sr: int, edit_markers, *, seconds: float = 15.0,
              edit_at: float = 7.0, prebuffer: float = 0.25,
              buf: int = 1024) -> dict:
    """The paced ``/audio/stream?from=0`` read for ``seconds`` of audio
    while a second connection polls /frame.png as fast as it can; one
    ``set_markers`` edit ``edit_at`` s after the first PCM byte.  The
    client plays ``prebuffer`` s after its first PCM byte: buffer i of
    ``buf`` samples underruns when its last byte arrives after its play
    time.  Then an unpaced stream (``pace=0``) from 0 to the end, with
    the poller still running.  The poller keeps polling until both are
    read."""
    import http.client
    import threading

    stop = threading.Event()
    polls, errors = [0], []

    def poller():
        c = UiClient(port)
        try:
            while not stop.is_set():
                c.get(UI_FRAME)
                polls[0] += 1
        except Exception as e:  # reported by the caller
            errors.append(repr(e))
        finally:
            c.close()

    th = threading.Thread(target=poller, name="frame-poller", daemon=True)
    th.start()
    edit = {}
    s = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        s.request("GET", "/audio/stream?from=0")
        r = s.getresponse()
        check(r.status == 200 and r.read(44)[:4] == b"RIFF", "stream header")
        first = r.read(1)
        t_first = time.monotonic()

        def edit_thread():
            if not stop.wait(max(0.0, t_first + edit_at - time.monotonic())):
                c = UiClient(port)
                try:
                    t = time.monotonic()
                    st = c.post("/control", {"action": "set_markers",
                                             "value": edit_markers})
                    edit.update(cursor=st["cursor"], wall=t - t_first,
                                ms=1e3 * (time.monotonic() - t))
                finally:
                    c.close()

        et = threading.Thread(target=edit_thread, name="edit", daemon=True)
        et.start()
        n_buf = int(seconds * sr) // buf
        parts, late, worst = [first + r.read(2 * buf - 1)], 0, -np.inf
        for i in range(n_buf):
            if i:
                parts.append(r.read(2 * buf))
            check(len(parts[-1]) == 2 * buf, "stream ended early")
            lag = time.monotonic() - (t_first + prebuffer + i * buf / sr)
            late += lag > 0
            worst = max(worst, lag)
        et.join(timeout=30)
        check(not et.is_alive() and "cursor" in edit, "the edit never ran")
    finally:
        s.close()
    s = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.monotonic()
        s.request("GET", "/audio/stream?from=0&pace=0")
        r = s.getresponse()
        whole = r.read()
        wall = time.monotonic() - t0
    finally:
        s.close()
        stop.set()
        th.join(timeout=60)
    check(not th.is_alive() and not errors, f"frame poller: {errors}")
    pcm = np.frombuffer(b"".join(parts), "<i2")
    return {"pcm": pcm, "underruns": int(late), "worst_lag_ms": 1e3 * worst,
            "edit": edit, "polls": polls[0],
            "unpaced_s": (len(whole) - 44) / 2 / sr, "unpaced_wall_s": wall,
            "x_realtime": (len(whole) - 44) / 2 / sr / wall}


def spectrogram_state(EditorState, Viewport, Config, path: str,
                      pyramid: bool):
    """The CLI ``spectrogram``'s scene set-up at its defaults (1280x720,
    the whole track, brightness 50), on the card."""
    ed = EditorState(config=Config(tile_source="pyramid") if pyramid
                     else Config(), viewport=Viewport(1280, 720),
                     warm_up=False)
    from melonix_tpu_torch.markers import sort_markers

    ed.open_file(path)
    ed.markers = sort_markers(ed.markers)
    ed.invalidate()
    ed.range_time = max(len(ed.wav) / ed.sample_rate, 0.001)
    ed.set_brightness(50.0)
    return ed


def editor_slice(mt, x: np.ndarray, card: str, root: str, twins) -> None:
    """Phase 24: the CLI's ``spectrogram`` on the song (B7, and B1 with
    ``--pyramid``) against the all-plain scene; an ``EditorServer`` on a
    30 s excerpt: the frame loop's four motions, the pitch overlay (B8),
    live playback through HTTP on the PV engine (B2, B3, B11) with a
    frame poller and a mid-stream edit, and ``/audio.wav`` on both engines
    (B5 + B6; B2-B4) against the renders.  Every check raises."""
    import torch

    from melonix_tpu_torch.cli import main as cli_main
    from melonix_tpu_torch.io.project import Project, save_project
    from melonix_tpu_torch.kernels import columns as kcols
    from melonix_tpu_torch.kernels import pitch as kpitch
    from melonix_tpu_torch.kernels import pv as kpv
    from melonix_tpu_torch.kernels import render as krender
    from melonix_tpu_torch.kernels import resample as kres
    from melonix_tpu_torch.ui import png as upng
    from melonix_tpu_torch.ui import view as uview
    from melonix_tpu_torch.ui.colormap import colormap_lut
    from melonix_tpu_torch.ui.state import (MOD_ALT, MOD_CTRL, EditorState,
                                            Viewport)
    from melonix_tpu_torch.ui.web import EditorServer, _pcm16
    from melonix_tpu_torch.utils import registry

    def pcm16(y) -> np.ndarray:  # the shell's int16 quantisation
        return np.frombuffer(_pcm16(y), "<i2")

    bars = load_oracle(root, "scene_bars")
    lut = colormap_lut()
    metric = lambda name: registry(name).value  # noqa: E731
    errors0 = metric("tiles.worker_errors")
    n = len(x)
    markers = bench_markers(mt, n)
    env0 = os.environ.get("MELONIX_AUTOSAVE_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MELONIX_AUTOSAVE_DIR"] = os.path.join(tmp, "autosave")
        # -- the scene: the CLI's spectrogram vs the all-plain scene -----
        mlx = save_project(os.path.join(tmp, "song.mlx"), Project(
            wav=x, sample_rate=SR, markers=markers))
        for pyramid in (False, True):
            out = os.path.join(tmp, f"scene{int(pyramid)}.png")
            argv = ["spectrogram", mlx, "-o", out, "--width", "1280",
                    "--height", "720"] + (["--pyramid"] if pyramid else [])
            chunks0 = metric("tiles.chunks")
            kcols.spectrogram_columns_fused.launches = 0
            kpv.stft_mag.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(cli_main(argv) == 0, f"spectrogram {argv}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b7 = kcols.spectrogram_columns_fused.launches
            b1 = kpv.stft_mag.launches
            chunks = metric("tiles.chunks") - chunks0
            with open(out, "rb") as f:
                got = bars.decode_png(f.read())
            with plain_twins(*twins):
                ed = spectrogram_state(EditorState, Viewport, mt.Config, mlx,
                                       pyramid)
                want = uview.render_scene(ed, synchronous_tiles=True)
                ed.tile_server.close()
            res = bars.scene_bars(got, want, uview, ed, lut)
            label = "--pyramid (B1)" if pyramid else "defaults (B7)"
            print(f"[24] spectrogram of the 180 s song with its 12 markers as "
                  f".mlx, 1280x720, {label}: wall {wall:.3f} s; launches B7 "
                  f"{b7} ({chunks} drained chunks), B1 {b1}; vs the all-plain "
                  f"scene: lane pixels equal {100 * res['lane_equal']:.4f}% "
                  f"(bar 99.9), max level diff {res['lane_max_level']} (bar 1), "
                  f"max channel diff {res['max_channel_diff']}, outside the "
                  f"lane bit-equal {res['outside_equal']} | {card}",
                  flush=True)
            check(res["outside_equal"] and res["lane_equal"] >= 0.999
                  and res["lane_max_level"] <= 1, f"scene bars {label}")
            if pyramid:
                check(b1 == 1 and b7 == 0, f"--pyramid launches B1 {b1}, B7 {b7}")
            else:
                check(b7 == chunks and b7 >= 8 and b1 == 0,
                      f"spectrogram launches B7 {b7} vs chunks {chunks}")

        # -- the frame loop on a 30 s excerpt --------------------------
        ex = np.ascontiguousarray(x[: 30 * SR])
        wav_path = os.path.join(tmp, "excerpt.wav")
        mt.write_wav(wav_path, ex, SR, dtype="float32")
        srv = EditorServer(autosave_interval=0)  # an EditorState on cuda
        srv._lock = TimedLock()
        t0 = time.perf_counter()
        srv.state.open_file(wav_path)
        open_ms = 1e3 * (time.perf_counter() - t0)
        cl = UiClient(srv.start())
        try:
            t0 = time.perf_counter()
            cl.get(UI_FRAME)
            first_ms = 1e3 * (time.perf_counter() - t0)
            settle_ms = ui_settle(cl)
            # the open's warm-up (runtime/warmup.py) ends before any launch
            # is counted; join re-raises what it raised
            warm = srv.state.warmup
            check(warm is not None, "the open started no warm-up")
            warm.join(timeout=300)
            check(not warm.is_alive() and warm.error is None,
                  "the open's warm-up")
            for _ in range(5):
                cl.get(UI_FRAME)
            fps = {}
            mid = {"kind": "motion", "x": 600, "y": 300, "buttons": 2}
            for name, event in (
                    ("ui_fps_steady", None),
                    ("ui_fps_pan", dict(mid, dx=6, dy=0)),
                    ("ui_fps_zoom", dict(mid, dx=0, dy=6, mods=MOD_CTRL)),
                    ("ui_fps_note_pan", dict(mid, dx=0, dy=6, mods=MOD_ALT))):
                fps[name] = ui_fps(cl, 2.0, event)
            # the other encoder: the stdlib PNG at level 1, as a machine
            # without Pillow serves every frame, and each encode alone
            img = uview.render_scene(srv.state)
            enc = {"frame": host_ms(lambda: upng.encode_frame(img)),
                   "png": host_ms(lambda: upng.encode_png(img, level=1))}
            pil, upng._PILImage = upng._PILImage, None
            try:
                fps["ui_fps_steady (no Pillow)"] = ui_fps(cl, 2.0)
            finally:
                upng._PILImage = pil
            print(f"[24] editor on a 30 s excerpt: open {open_ms:.1f} ms, "
                  f"first frame {first_ms:.1f} ms, tiles settled "
                  f"{settle_ms:.1f} ms later; frame loop at 1280x720 (2 s "
                  f"bursts): " + ", ".join(f"{k} {v:.1f} ({m})" for k, (v, m)
                                             in fps.items())
                  + f"; one 1280x720 encode: encode_frame {enc['frame']:.2f} "
                  f"ms ({'JPEG' if pil is not None else 'PNG'}), stdlib PNG "
                  f"level 1 {enc['png']:.2f} ms | {card}", flush=True)
            check(all(v > 0 for v, _m in fps.values()), "frame loop")

            # -- the pitch overlay (B8, in the state's pitch thread) -----
            kpitch.pitch_ac.launches = 0
            t0 = time.perf_counter()
            cl.post("/control", {"action": "pitchcurve", "value": 1})
            while srv.state.pitch is None:
                check(time.perf_counter() - t0 < 60.0, "pitch overlay absent")
                time.sleep(0.005)
            pitch_ms = 1e3 * (time.perf_counter() - t0)
            b8 = kpitch.pitch_ac.launches
            body, _mime = cl.get(UI_FRAME)
            curve = srv.state.pitch
            print(f"[24] pitch overlay: curve of {len(curve.note)} frames "
                  f"({100 * float(np.mean(curve.voiced)):.1f}% voiced) landed "
                  f"{pitch_ms:.1f} ms after /control; B8 launches {b8} | "
                  f"{card}", flush=True)
            check(b8 == 1 and curve.voiced.mean() > 0.5, "pitch overlay B8")
            cl.post("/control", {"action": "pitchcurve", "value": 0})

            # -- live playback through HTTP on the PV engine -----------
            cl.post("/control", {"action": "engine", "value": "pv"})
            st = srv.state
            new = [mt.Marker(m.sample, m.note, -m.d_time,
                             -1.5 * m.pitch_bend)
                   for m in mt.sort_markers(bench_markers(mt, len(ex)))]
            old_knots = st.knots
            counters = (kpv.analysis, kpv.synth_ola_phase, kres.resample_lerp)
            for fn in counters:
                fn.launches = 0
            cl.close()  # idle through the stream: the server's 30 s timeout
            live = live_http(srv.port, SR, [m.to_dict() for m in new])
            cl = UiClient(srv.port)
            live_launches = {fn.__name__: fn.launches for fn in counters}
            new_knots = st.knots
            pcm = live["pcm"].astype(np.float32) / 32768.0
            j_edit = int(round(live["edit"]["cursor"] * SR))
            half = SR // 2
            check(j_edit + half + 2 * SR <= len(pcm) and j_edit > 2 * SR,
                  f"edit at sample {j_edit} leaves too little stream")
            # Before the edit: the stream from 0 is the offline render.
            old = mt.render_track_pv(ex, old_knots, device="cuda")
            pre = torch.from_numpy(pcm[half:j_edit])
            pre_rms, pre_env = rms_env(pre, torch.from_numpy(
                pcm16(old[half:j_edit]).astype(np.float32) / 32768.0))
            # After it: the PV render of the new edit restarted at the
            # edit's cursor (the stream re-anchors phase there), held from
            # 0.5 s on; and not the old edit's.
            from melonix_tpu_torch.engine.pv_stream import PvStream

            def restarted(knots):
                s_ = PvStream(ex, knots, start_sec=live["edit"]["cursor"])
                return s_.read(half + 2 * SR)[half:]

            post = torch.from_numpy(pcm[j_edit + half: j_edit + half + 2 * SR])
            ref_new = torch.from_numpy(pcm16(restarted(new_knots)).astype(
                np.float32) / 32768.0)
            ref_old = torch.from_numpy(pcm16(restarted(old_knots)).astype(
                np.float32) / 32768.0)
            post_rms, post_env = rms_env(post, ref_new)
            old_rms, old_env = rms_env(post, ref_old)
            print(f"[24] live HTTP (PV engine, paced, 15 s, frame poller "
                  f"{live['polls']} frames): live_http_underruns "
                  f"{live['underruns']} (bar 0; client plays 0.25 s after its "
                  f"first PCM byte; latest buffer {live['worst_lag_ms']:.1f} "
                  f"ms after its play time, negative: before it), "
                  f"edit at {live['edit']['wall']:.2f} s (cursor "
                  f"{live['edit']['cursor']:.3f} s, /control "
                  f"{live['edit']['ms']:.1f} ms); unpaced to the end: "
                  f"{live['unpaced_s']:.2f} s in {live['unpaced_wall_s']:.3f} "
                  f"s, live_http_x_realtime {live['x_realtime']:.2f} (bar > 1); "
                  f"launches {live_launches} | {card}", flush=True)
            print(f"     before the edit vs render_track_pv: rms {pre_rms:.2e} "
                  f"env {pre_env:.2e}; from 0.5 s after it vs the new edit "
                  f"restarted at its cursor: rms {post_rms:.2e} env "
                  f"{post_env:.2e} (bars 5e-3, 2e-2); vs the old edit "
                  f"restarted there: rms {old_rms:.2e} env {old_env:.2e} | "
                  f"{card}", flush=True)
            check(live["underruns"] == 0, "live_http_underruns")
            check(live["x_realtime"] > 1.0, "live_http_x_realtime")
            check(live_launches["resample_lerp"] > 0
                  and live_launches["analysis"] > 0
                  and live_launches["synth_ola_phase"] > 0, "live launches")
            check(pre_rms < 5e-3 and pre_env < 2e-2, "stream before the edit")
            check(post_rms < 5e-3 and post_env < 2e-2, "the edit is heard")
            check(old_rms > 5e-2, "the stream after the edit is the old one")

            # -- /audio.wav on both engines vs the renders --------------
            exports = {}
            for engine in ("granular", "pv"):
                cl.post("/control", {"action": "engine", "value": engine})
                cnt = (krender.render_granular,) if engine == "granular" else (
                    kpv.analysis, kpv.synth_ola_phase, kres.resample_pv)
                for fn in cnt:
                    fn.launches = 0
                t0 = time.perf_counter()
                body, mime = cl.get("/audio.wav")
                ms = 1e3 * (time.perf_counter() - t0)
                launches = {fn.__name__: fn.launches for fn in cnt}
                got = np.frombuffer(body[44:], "<i2")
                if engine == "granular":
                    want = mt.render_track(st.wav, st.grains, st.knots,
                                           device="cuda")
                else:
                    want = mt.render_track_pv(st.wav, st.knots, device="cuda")
                want = pcm16(want)
                rms, env = rms_env(torch.from_numpy(got.astype(np.float32)),
                                   torch.from_numpy(want.astype(np.float32)))
                exports[engine] = (ms, launches, bool(np.array_equal(got, want)),
                                   rms, env)
                check(mime == "audio/wav" and len(got) == len(want),
                      f"/audio.wav {engine}")
            print("[24] /audio.wav: " + "; ".join(
                f"{e} {ms:.1f} ms, launches {la}, bit-equal to the render "
                f"{eq} (rms {rms:.2e}, env {env:.2e})"
                for e, (ms, la, eq, rms, env) in exports.items())
                + f" | {card}", flush=True)
            check(exports["granular"][2], "granular /audio.wav vs render_track")
            check(exports["granular"][1]["render_granular"] == 1,
                  "granular /audio.wav launches")
            check(exports["pv"][3] < 5e-3 and exports["pv"][4] < 2e-2,
                  "PV /audio.wav vs render_track_pv")
            check(all(v >= 1 for v in exports["pv"][1].values()),
                  "PV /audio.wav launches")
            holds = sorted(srv._lock.holds.items(), key=lambda kv: -max(kv[1]))
            print("[24] server lock holds by holder (count; median, 99th "
                  "percentile, longest ms): " + ", ".join(
                      f"{k} ({len(v)}; {np.median(v):.2f}, "
                      f"{np.percentile(v, 99):.2f}, {max(v):.2f})"
                      for k, v in holds[:8]) + f" | {card}", flush=True)
            errors = metric("tiles.worker_errors") - errors0
            check(errors == 0, f"{errors} tile worker errors")
        finally:
            cl.close()
            srv.stop()
            if env0 is None:
                os.environ.pop("MELONIX_AUTOSAVE_DIR", None)
            else:
                os.environ["MELONIX_AUTOSAVE_DIR"] = env0


# Phase 25: the warm-up at open (runtime/warmup.py), in fresh processes


FIRST_USES = ("tile_burst", "render_track_pv", "render_track",
              "pv_stream_read")


def first_use_main(argv) -> int:
    """One fresh process of phase 25 (``chip_smoke.py --first-use MODE
    --out FILE``): opens an ``EditorState`` on the card over phase 24's
    30 s excerpt and times, each between two ``torch.cuda.synchronize``
    calls on a host clock, the first 100-column tile burst, the first
    ``render_track_pv`` and ``render_track`` of the 12-marker edit and the
    first 8192-sample ``PvStream`` read after a restart at 10 s.  ``warm``
    joins the open's warm-up first; ``cold`` patches the warm-up (and the
    kernel build it starts before the decode) away, as the editor opened
    before it had one.  Writes the outputs to FILE (``.npz``) and the times
    to FILE + ``.json``."""
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--first-use", choices=("warm", "cold"), required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.engine.pv_stream import PvStream
    from melonix_tpu_torch.runtime import warmup
    from melonix_tpu_torch.ui.state import EditorState

    marks: dict = {"kind": torch.cuda.get_device_name(0)}
    if a.first_use == "cold":
        warmup.warmup_session_async = lambda *args, **kw: None
        warmup.build_async = lambda: None
    else:
        real = warmup.warmup_session

        def timed(*args, **kw):  # the warm-up's own wall, on its thread
            t0 = time.perf_counter()
            real(*args, **kw)
            marks["warmup_s"] = time.perf_counter() - t0

        warmup.warmup_session = timed
    ex = np.ascontiguousarray(make_song(SR, SECONDS)[: 30 * SR])
    n = len(ex)
    knots = mt.MapKnots.from_markers(bench_markers(mt, n), SR, n)
    burst = [(i, (i + 1) * n // 128 - int(0.02 * SR), (i + 1) * n // 128)
             for i in range(100)]
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "excerpt.wav")
        mt.write_wav(path, ex, SR, dtype="float32")
        st = EditorState()
        t0 = time.perf_counter()
        st.open_file(path)
        marks["open_s"] = time.perf_counter() - t0
        if a.first_use == "warm":
            t0 = time.perf_counter()
            st.warmup.join(timeout=600)  # re-raises what the warm-up raised
            marks["join_s"] = time.perf_counter() - t0
            check(not st.warmup.is_alive(), "the warm-up did not end")
            marks["warmup_error"] = repr(st.warmup.error)
        else:
            check(st.warmup is None, "a warm-up ran with it patched away")

        def tiles():
            t0 = time.perf_counter()
            while True:
                got = st.tile_server.get_tiles(burst)
                if all(g is not None for g in got):
                    return np.stack(got)
                check(time.perf_counter() - t0 < 120.0, "tiles never came")
                time.sleep(0.001)

        for label, fn in zip(FIRST_USES, (
                tiles,
                lambda: mt.render_track_pv(ex, knots),
                lambda: mt.render_track(ex, st.grains, knots),
                lambda: PvStream(ex, knots, start_sec=10.0).read(8192))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[label] = np.asarray(fn())
            torch.cuda.synchronize()
            marks[label + "_ms"] = 1e3 * (time.perf_counter() - t0)
        st.tile_server.close()
    np.savez(a.out, **outs)
    with open(a.out + ".json", "w") as f:
        json.dump(marks, f)
    return 0


def first_use_phase(card: str, root: str) -> None:
    """Phase 25: :func:`first_use_main` in two fresh processes, warm (a)
    and cold (b); the first uses' times, the warm-up's own wall; every
    output of (a) bit-equal to (b)'s (the tiles and the granular export
    are exact, B3 and B4 deterministic) and no warm-up error."""
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("warm", "cold"):
            out = os.path.join(tmp, f"{mode}.npz")
            proc = subprocess.run(
                [sys.executable, os.path.join(root, "chip_smoke.py"),
                 "--first-use", mode, "--out", out],
                capture_output=True, text=True, timeout=600, cwd=root)
            check(proc.returncode == 0 and "warm-up failed" not in proc.stderr,
                  f"phase 25 ({mode}) rc {proc.returncode}:\n"
                  f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
            with np.load(out) as z, open(out + ".json") as f:
                res[mode] = (json.load(f), {k: z[k] for k in z.files})
    (mw, ow), (mc, oc) = res["warm"], res["cold"]
    same = {k: bool(np.array_equal(ow[k], oc[k])) for k in FIRST_USES}
    print(f"[25] warm-up at open on a 30 s excerpt ({mw['kind']}): open "
          f"{mw['open_s']:.3f} s, the warm-up's own wall {mw['warmup_s']:.3f} "
          f"s (joined {mw['join_s']:.3f} s after the open), error "
          f"{mw['warmup_error']}; first uses after it vs with it patched away "
          f"(open {mc['open_s']:.3f} s), ms: " + ", ".join(
              f"{k} {mw[k + '_ms']:.2f} vs {mc[k + '_ms']:.2f}"
              for k in FIRST_USES) + f"; bit-equal {same} | {card}",
          flush=True)
    check(mw["warmup_error"] == "None", "the warm-up raised")
    check(all(same.values()), f"warmed outputs differ from cold: {same}")


# Phase 26: a track longer than one stretch chunk


def two_chunk_render(mt, pv, twins, card: str) -> None:
    """Phase 26: ``render_track_pv`` at its defaults of a 720 s song with
    12 markers (two chunks of ``PV_CHUNK_FRAMES``, no forced chunk) against
    the all-plain render at the PV bars; its wall and peak device memory."""
    import torch

    from melonix_tpu_torch.kernels import pv as kpv
    from melonix_tpu_torch.kernels import resample as kres

    x = make_song(SR, 720.0)
    n = len(x)
    knots = mt.MapKnots.from_markers(bench_markers(mt, n), SR, n)
    plan = pv.build_pv_plan(knots, n)
    chunks = -(-plan.n_frames // pv.PV_CHUNK_FRAMES)
    check(chunks == 2, f"{plan.n_frames} frames make {chunks} chunks, not 2")
    counters = (kpv.analysis, kpv.synth_ola_phase, kres.resample_pv)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = mt.render_track_pv(x, knots, device_out=True)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = {fn.__name__: fn.launches for fn in counters}
    with plain_twins(*twins):
        ref = mt.render_track_pv(x, knots, device_out=True)
    rms, env = rms_env(out, ref)
    print(f"[26] render_track_pv of a 720 s song ({n} samples, "
          f"{plan.n_frames} frames, {chunks} chunks of {pv.PV_CHUNK_FRAMES}, "
          f"n_out {out.shape[0]}): wall {wall_ms:.2f} ms (NumPy in, the "
          f"host plan included), peak device memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}; vs the all-plain render: rms {rms:.2e} (bar "
          f"5e-3 of max), envelope {env:.2e} (bar 2e-2) | {card}",
          flush=True)
    check(bool(torch.isfinite(out).all()) and out.shape == ref.shape
          and out.shape[0] == plan.n_out, "two-chunk render shape")
    check(launches["analysis"] == chunks and launches["synth_ola_phase"]
          == chunks and launches["resample_pv"] == 1, "two-chunk launches")
    check(rms < 5e-3 and env < 2e-2, "two-chunk render vs plain")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
          f"({len(native.SOURCES)} sources) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    ptxas:", line.strip())
    for name, regs, spill, stack in synth_ptxas(
            (_build.BUILD_DIR / "nvcc.log").read_text()):
        print(f"    ptxas {name}: {regs} registers, {spill} bytes spill "
              f"stores, {stack} bytes stack frame", flush=True)

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
               flops, fn_graph=None):
        """One row of the kernels line; ``fn_lib`` is the one PyTorch call
        timed beside the kernel as a yardstick (None where there is none),
        ``n_bytes`` / ``flops`` the work the bound is computed from;
        ``fn_graph`` (launch-bound rows) is what :func:`graph_ms` captures
        for the row's ``device_ms`` (null elsewhere)."""
        bound_ms, bound_by = bound(n_bytes, flops)
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=replaces, launches=0, max_abs_err=err,
                          bound_ms=bound_ms, bound_by=bound_by,
                          device_ms=None, run_kernel=fn_k, run_plain=fn_p,
                          run_library=fn_lib, run_graph=fn_graph)

    # B3's and B10's two overlap-add routes: the hop's own (fused at the
    # path's hop) held bit for bit to the frames route, both timed in
    # phase 22 beside the scan alone and cuFFT's irfft
    route_rows = []

    def both_routes(label, fn, got, scan, lib):
        """``fn(route)`` runs the kernel on one route; ``got`` is what the
        hop's own route returned."""
        other = fn("frames")
        torch.cuda.synchronize()
        same = bit_equal(other if isinstance(other, tuple) else (other,),
                         got if isinstance(got, tuple) else (got,))
        print(f"    {label}: {kpv.ola_route(hop)} route vs frames route "
              f"bit-equal {same} (bar: equal)", flush=True)
        check(kpv.ola_route(hop) == "fused" and same,
              f"{label}: fused vs frames route")
        route_rows.append((label, lambda: fn(None), lambda: fn("frames"),
                           scan, lib))

    b1 = lambda: kpv.stft_mag(wav, win, size, hop, nf)  # noqa: E731
    b1p = lambda: kpv.stft_mag_plain(wav, win, size, hop, nf)  # noqa: E731
    got, want = b1(), b1p()
    torch.cuda.synchronize()
    s = snr_db(got, want)
    print(f"[3] B1 stft_mag: SNR {s:.1f} dB (bar < -100), max abs err "
          f"{max_err(got, want):.3e}", flush=True)
    check(got.shape == (nf, size // 2) and s < -100.0, "B1 vs twin")
    # the pair transform's edges: a hop that is no multiple of 128, an odd
    # frame count (the last frame paired with silence), one frame, and a
    # track shorter than a frame (zero fill)
    short = wav[:1500]
    for label, w_, hp_, nf_ in (
            ("hop 441", wav, 441, num_frames(n, size, 441)),
            ("odd count", wav, hop, nf - 1 if nf % 2 == 0 else nf),
            ("one frame", wav, hop, 1),
            ("1500-sample track", short, hop, 3)):
        g_, w_p = (kpv.stft_mag(w_, win, size, hp_, nf_),
                   kpv.stft_mag_plain(w_, win, size, hp_, nf_))
        torch.cuda.synchronize()
        s_ = snr_db(g_, w_p)
        print(f"    B1 stft_mag, {label} ({nf_} frames, hop {hp_}): SNR "
              f"{s_:.1f} dB (bar < -100), finite "
              f"{bool(torch.isfinite(g_).all())}", flush=True)
        check(g_.shape == (nf_, size // 2) and s_ < -100.0
              and bool(torch.isfinite(g_).all()), f"B1 {label} vs twin")
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
    both_routes("B3 (re, im)",
                lambda route: kpv.synth_ola_phase(*b3_args, route=route),
                (y_k, r_k, pl_k, p0_k), sc,
                lambda: torch.fft.irfft(spec_b3, n=size))
    # a later chunk: global frame offset, padded tail, carries from above;
    # 15,027 frames, so the scan's last tile and last run are partial
    # (15,104 is 118 whole tiles of 128) and B2 pairs its last frame with
    # silence
    f_odd = plan.n_frames - 77
    m0_late, f_late = 3 * plan.n_frames, f_odd - 17
    late = (re_k[:f_odd], im_k[:f_odd], da[:f_odd], win, m0_late, f_late,
            p0_p, r_p, pl_p, size, hop)
    lk, lp = kpv.synth_ola_phase(*late), kpv.synth_ola_phase_plain(*late)
    lu = kpv.synth_ola_phase(*late, route="frames")
    torch.cuda.synchronize()
    check(bit_equal(lk, lu), "B3 later chunk: fused vs frames route")
    rms, env = rms_env(lk[0], lp[0])
    r_ok = float(((lk[1] - lp[1]).abs() < 1e-2).float().mean())
    e_pl, e_p0 = max_err(lk[2], lp[2]), max_err(lk[3], lp[3])
    print(f"    B3 later chunk ({f_odd} frames, m0 {m0_late}, f_real {f_late})"
          f": rms {rms:.2e}, envelope {env:.2e}, phi0_eff {e_p0:.2e}, "
          f"phi_last {e_pl:.2e}, resid_last within 1e-2 on "
          f"{100 * r_ok:.1f}% of bins (same bars); fused vs frames route "
          f"bit-equal True (bar: equal)", flush=True)
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
    got, want, again = b4(), b4p(), b4()
    glue = pv._resample_pv_fused(plan, y)
    torch.cuda.synchronize()
    s, e = snr_db(got, want), max_err(got, want)
    print(f"    B4 resample_pv (expm1f) vs twin (expm1_precise) on the song: "
          f"SNR {s:.1f} dB (bar < -60), max abs err {e:.3e} (bar 5e-3), kmax "
          f"{kmax} anchors a block; two calls bit-equal "
          f"{torch.equal(got, again)}, through the render's packed upload "
          f"bit-equal {torch.equal(got, glue)} (bars: equal)", flush=True)
    check(got.shape == (plan.n_out_pad,) and s < -60.0 and e < 5e-3,
          "B4 vs twin")
    check(torch.equal(got, again) and torch.equal(got, glue),
          "B4: two calls, or the packed upload, differ")
    record("resample_pv", "melonix_tpu_torch/csrc/resample_pv.cu",
           "melonix_tpu/kernels/pallas_resample.py:202", e, b4, b4p, None,
           nbytes(y, base, a0_d, cnt_d, *anc, got), 0.0, fn_graph=b4)
    del again, glue

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
    _a0, _cnt, kmax_g = krender.compact_blocks(offs,
                                               -(-total // krender.CBLK))
    n_fix = int((fix_idx < total).sum())
    print(f"[6] granular host: grains {len(table)} (native {1e3 * t_grains:.2f}"
          f" ms, NumPy {1e3 * t_grains_np:.1f} ms, equal), plan steps "
          f"{gplan.n_steps} (native {1e3 * t_plan:.2f} ms, NumPy "
          f"{1e3 * t_plan_np:.1f} ms, equal), total_out {total}, buckets "
          f"gmax {gmax} szmax {szmax}, compact kmax {kmax_g}, seam fixes "
          f"{n_fix} ({1e3 * t_fix:.2f} ms)", flush=True)

    # -- 7. B5 + B6, one kernel, against its twin and the two twins ----
    # on the song's plan and on one with +-24 st bends (rates 0.25 to 4,
    # a larger szmax, more candidates a block); the six plan and block
    # arrays go up in one packed copy, as render_full sends them
    bend_knots = mt.MapKnots.from_markers(
        [mt.Marker(sample=int((i + 1) * n / 14), note=57.0, d_time=0.0,
                   pitch_bend=24.0 * (-1) ** i) for i in range(12)], SR, n)

    def granular_calls(ops, out_len, p_szmax):
        """(kernel, twin) calls of one plan's packed operands."""
        gs_, sz_, off_, a0_, cnt_, rate_ = ops
        return (lambda: krender.render_granular(wav, gs_, rate_, sz_, off_,
                                                a0_, cnt_, out_len, p_szmax),
                lambda: krender.render_granular_plain(wav, gs_, rate_, sz_,
                                                      off_, out_len, p_szmax))

    for label, p in (("the song's plan", gplan),
                     ("a plan with +-24 st bends",
                      mt.build_render_plan(table, bend_knots))):
        p_offs, p_total = p.out_offset[:-1], p.total_out
        _g, p_szmax = krender._buckets(p)
        p_a0, p_cnt, p_kmax = krender.compact_blocks(
            p_offs, -(-p_total // krender.CBLK))
        ops = _build.upload_packed(
            (p.grain_start, p.sz, p_offs, p_a0, p_cnt), (p.rate,), dev)
        gs_d, sz_d, off_d, _a0, _cnt, rate_d = ops
        b56, b56p = granular_calls(ops, p_total, p_szmax)
        got, again, want = b56(), b56(), b56p()
        pair = krender.compact_plain(krender.render_steps_plain(
            wav, gs_d, rate_d, sz_d, p_szmax), off_d, p_total)
        torch.cuda.synchronize()
        e = max_err(got, want)
        print(f"[7] B5 + B6 render_granular, {label} ({p.n_steps} steps, "
              f"rates {float(p.rate.min()):.4f}-{float(p.rate.max()):.4f}, "
              f"szmax {p_szmax}, kmax {p_kmax} steps a block, {p_total} "
              f"samples): equal to its twin {torch.equal(got, want)}, to "
              f"compact_plain(render_steps_plain) {torch.equal(got, pair)}, "
              f"two calls {torch.equal(got, again)}; max abs err {e:.3e} "
              f"(bars: equal)", flush=True)
        check(got.shape == (p_total,) and torch.equal(got, want)
              and torch.equal(got, pair) and torch.equal(got, again),
              f"render_granular vs twins, {label}")
        if p is gplan:
            # the least it must move: each tap of the live outputs once,
            # the track written once, the plan and block arrays read once
            j_out = torch.arange(p_total, device=dev)
            step = (torch.searchsorted(off_d.long(), j_out, right=True)
                    - 1).clamp_min(0)
            rel = j_out - off_d.long()[step]
            live = (rel >= 0) & (rel < sz_d.long()[step].clamp_max(p_szmax))
            src = (gs_d.long()[step]
                   + torch.floor(rel.float() * rate_d[step]).long())[live]
            taps = torch.cat([src, src + 1])
            n_taps = int(torch.unique(taps[(taps >= 0) & (taps < n)]).numel())
            record("render_granular",
                   "melonix_tpu_torch/csrc/render_granular.cu",
                   "melonix_tpu/kernels/pallas_render.py:108 + :375", e, b56,
                   b56p, None, 4 * n_taps + nbytes(got, *ops), 0.0,
                   fn_graph=b56)
            print(f"    the bound's bytes: {n_taps} taps read, {p_total} "
                  f"samples written, plan and blocks {nbytes(*ops)}",
                  flush=True)
            del j_out, step, rel, live, src, taps
        del got, again, want, pair, ops

    # -- 8. the granular main path: render_track ----------------------
    def granular():
        tab = mt.build_grain_table(x)
        return mt.render_track(x, tab, knots, device=dev, device_out=True)

    gcounters = (krender.render_granular,)
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
    edge_parity = granular_edge_parity_max_err(mt, oracle, dev)
    print(f"[8] granular path: render_track n_out {out_g.shape[0]} (bar "
          f"{total}), finite, {trailing} trailing zeros (bar 1500); equal to "
          f"all-plain path {torch.equal(out_g, out_gp)}, to render_device "
          f"{torch.equal(out_g, out_rd)}; granular_parity_max_err {parity} "
          f"(bar 0.0); on the 4 degenerate marker sets of "
          f"test_fuzz_parity.py {edge_parity} (bar 0.0)", flush=True)
    check(out_g.shape == (total,) and bool(torch.isfinite(out_g).all()),
          "granular output length / finite")
    check(trailing == 1500, f"{trailing} trailing zeros")
    check(torch.equal(out_g, out_gp), "render_track vs all-plain path")
    check(torch.equal(out_g, out_rd), "render_track vs render_device")
    check(parity == 0.0, f"granular_parity_max_err {parity}")
    check(edge_parity == 0.0, f"degenerate marker sets: {edge_parity}")
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
        before = krender.render_granular.launches
        check(cli_main(["render", src, "-o", dst, "--dtype", "float32"]) == 0,
              "CLI render")
        cli_out, _rate = mt.read_wav(dst)
        want = mt.render_track(clip, mt.build_grain_table(clip),
                               mt.MapKnots.from_markers([], SR, len(clip)),
                               device="cpu")
        check(krender.render_granular.launches > before, "CLI ran no kernel")
        check(np.array_equal(cli_out, want), "CLI (cuda) vs render_track (cpu)")
    print("    CLI render (granular, --device cuda by default) equals the CPU "
          "render_track bit for bit", flush=True)

    # -- 9. B7 against its twin and the float64 oracle ----------------
    # by route (kcols.route): 32,768 points (the default) and 16,384 on
    # fft_large.cuh's one-CTA transforms (Large<16384>, fft_pair.cuh's 8192
    # instance), 1024 and 8192 packed on Pair<512> and Pair<4096>, 3072 (m =
    # 3, P = 512), 24,576, 48,128 (m = 47) and 49,152 (m = 3, P = 8192, T =
    # 1) on the frame tile (fft_fourstep.cuh); each size also through
    # spectrogram_columns, the entry point, whose launches its row carries
    cfg = mt.DEFAULT_CONFIG
    csize, kgain = cfg.spectr_size, cfg.brightness_to_k()
    span = int(0.02 * SR)  # 20 ms columns: a zoomed-in view
    zoom_end = n // 3 + span * np.arange(1, 257)
    wide_s, wide_e = view_column_ranges(knots, 256, 0.0, knots.duration())
    col_sets = {"zoomed (256 x 20 ms from n / 3)": (zoom_end - span, zoom_end),
                "spread (256 columns over the edited track)": (wide_s, wide_e)}

    def b7_check(size, way, label, cs_np, ce_np, ph):
        """B7 at ``size`` on columns [cs, ce) against its twin: magnitudes
        SNR < -100 dB, packed texels >= 99.9% equal with max diff 1, the
        route ``way``."""
        cs, ce = put(cs_np.astype(np.int32)), put(ce_np.astype(np.int32))
        args = (wav, cs, ce, kgain)
        mk = kcols.spectrogram_columns_fused(*args, size=size, colormap=False)
        mp = kcols.spectrogram_columns_plain(*args, size=size, colormap=False)
        pk = kcols.spectrogram_columns_fused(*args, size=size)
        pp = kcols.spectrogram_columns_plain(*args, size=size)
        torch.cuda.synchronize()
        s = snr_db(mk, mp)
        eq, dmax = planes_close(unpack_rgb(pk).cpu().numpy(),
                                unpack_rgb(pp).cpu().numpy())
        print(f"[{ph}] B7 at {size} (route {kcols.route(size)}, bar {way}), "
              f"{label}: magnitudes SNR {s:.1f} dB (bar < -100), max abs err "
              f"{max_err(mk, mp):.3e}; packed RGB equal on {100 * eq:.4f}% "
              f"(bar 99.9), max diff {dmax} (bar 1)", flush=True)
        check(kcols.route(size) == way, f"B7 {size} route")
        check(mk.shape == (len(cs_np), size // 2) and pk.dtype == torch.int32
              and s < -100.0, f"B7 {size} {label} magnitudes vs twin")
        check(eq >= 0.999 and dmax <= 1, f"B7 {size} {label} texels vs twin")

    def b7_oracle(size, ends, ph):
        """spectrogram_columns (NumPy in and out, cuda) at ``size`` on 12
        columns against the float64 oracle (bench.py:136-156): SNR < -60 dB,
        argmax equal, one B7 launch.  Returns the launches."""
        cfg_s = dataclasses.replace(cfg, spectr_size=size)
        kcols.spectrogram_columns_fused.launches = 0
        got = mt.spectrogram_columns(x, ends - span, ends, cfg_s)
        launches = kcols.spectrogram_columns_fused.launches
        want = np.stack([column_f64(x, int(b) - span, int(b), size)
                         for b in ends])
        s = 10.0 * np.log10(np.sum((got - want) ** 2) / np.sum(want ** 2))
        arg_eq = bool(np.array_equal(got.argmax(1), want.argmax(1)))
        print(f"    spectrogram_columns at {size} vs float64 oracle (12 "
              f"columns): SNR {s:.1f} dB (bar < -60), argmax equal {arg_eq}, "
              f"B7 launches {launches} (bar 1)", flush=True)
        check(got.shape == (12, size // 2) and s < -60.0 and arg_eq
              and launches == 1, f"B7 {size} vs float64 oracle")
        return launches

    def b7_row(name, size, s_np, e_np, ph_launches, graph=False):
        """A kernel row for B7 at ``size`` on columns [s, e); with ``graph``
        also its device time (one CUDA graph of the calls)."""
        cs_t, ce_t = put(s_np.astype(np.int32)), put(e_np.astype(np.int32))
        b7 = lambda: kcols.spectrogram_columns_fused(  # noqa: E731
            wav, cs_t, ce_t, kgain, size=size, colormap=False)
        b7p = lambda: kcols.spectrogram_columns_plain(  # noqa: E731
            wav, cs_t, ce_t, kgain, size=size, colormap=False)
        frames = kcols.extract_frames(wav, cs_t, ce_t, size, cfg.spec_decay)
        ends_c = np.clip(e_np.astype(np.int64), 0, n + size)
        record(name, "melonix_tpu_torch/csrc/spectrogram_columns.cu",
               "melonix_tpu/kernels/pallas_columns.py:168",
               max_err(b7(), b7p()), b7, b7p, lambda: torch.fft.rfft(frames),
               4 * covered_len(ends_c - size, ends_c, n) + nbytes(cs_t, ce_t)
               + 4 * len(s_np) * (size // 2), fft_flops(len(s_np), size),
               fn_graph=b7 if graph else None)
        rows[name]["launches"] = ph_launches

    for label, (cs_np, ce_np) in col_sets.items():
        b7_check(csize, "large", label, cs_np, ce_np, 9)
    o_end = np.linspace(csize, n - 1, 12).astype(np.int64)  # bench.py:148-150
    b7_oracle(csize, o_end, 9)
    b7_row("spectrogram_columns", csize, wide_s, wide_e, 0)  # launches: [11]
    b7_check(16384, "large", "spread (256 columns over the edited track)",
             wide_s, wide_e, 9)
    launches16 = b7_oracle(16384, np.linspace(16384, n - 1, 12).astype(
        np.int64), 9)
    b7_row("spectrogram_columns_16384", 16384, wide_s, wide_e, launches16)
    for small, way, row in ((1024, "large", None),
                            (8192, "large", "spectrogram_columns_8192"),
                            (3072, "tile", None),
                            (24576, "tile", "spectrogram_columns_tile_24576"),
                            (48128, "tile", None), (49152, "tile", None)):
        b7_check(small, way, "spread (256 columns over the edited track)",
                 wide_s, wide_e, 9)
        launches_s = b7_oracle(small, np.linspace(small, n - 1, 12).astype(
            np.int64), 9)
        if row is not None:
            b7_row(row, small, wide_s, wide_e, launches_s, graph=True)
    # the frame tile at a column count that is no multiple of its T (T = 4
    # at 3072 for 1280 columns: the last CTA takes 3 of its 4)
    vs9, ve9 = view_column_ranges(knots, 1279, 0.0, knots.duration())
    check(kstft.frame_tile(3072, 1279)["t"] == 4,
          "B7 3072 T at 1279 columns")
    b7_check(3072, "tile", "1279 columns (T = 4, the last tile short)", vs9,
             ve9, 9)

    # -- 10. B12 against its twin; the |STFT| pyramid's two routes -----
    # each size by its route (kstft.route): the pair transform at powers of
    # two up to 8192, fft_large.cuh's one-CTA transforms at 16,384 and
    # 32,768, the frame tile (fft_fourstep.cuh) at 1536, 2560 (m = 5),
    # 24,576, 48,640 (m = 95) and 49,152; each also through
    # stft_mags_device, the entry point, whose launches the rows carry
    def b12_check(sz, hp, nfz, way, name, ph, track=None):
        """B12 at (sz, hp) over nfz frames by route ``way``: against its twin
        (< -80 dB) and float64 |rfft| of up to 8 frames (< -60 dB), through
        stft_mags_device (one launch, equal output); a kernel row unless
        ``name`` is None.  ``track``: (tensor on the card, NumPy array) in
        place of the song."""
        wav, x = track if track is not None else (song_d, song_np)
        n = len(x)
        w_d = put(hann_window(sz))
        got = kstft.stft_mag(wav, w_d, sz, hp, nfz)
        want = kstft.stft_mag_plain(wav, w_d, sz, hp, nfz)
        kstft.stft_mag.launches = 0
        via = mt.stft_mags_device(wav, w_d, sz, hp, nfz)
        torch.cuda.synchronize()
        launches_z = kstft.stft_mag.launches
        s, e = snr_db(got, want), max_err(got, want)
        pick = np.linspace(0, nfz - 1, min(nfz, 8)).astype(np.int64)
        xp = np.concatenate([x, np.zeros(sz, np.float32)])
        fr64 = np.stack([xp[f * hp: f * hp + sz] for f in pick]).astype(
            np.float64) * hann_window(sz).astype(np.float64)
        o64 = np.abs(np.fft.rfft(fr64)[:, : sz // 2])
        s64 = 10.0 * np.log10(np.sum((got[pick].cpu().numpy() - o64) ** 2)
                              / np.sum(o64 ** 2))
        print(f"[{ph}] B12 stft_mag_sizes {sz}/{hp} ({nfz} frames, route "
              f"{kstft.route(sz)}, bar {way}): SNR {s:.1f} dB (bar < -80), "
              f"max abs err {e:.3e}; {len(pick)} frames vs float64 |rfft| "
              f"{s64:.1f} dB (bar < -60); stft_mags_device launches "
              f"{launches_z} (bar 1), equal {bool(torch.equal(via, got))}",
              flush=True)
        check(kstft.route(sz) == way, f"B12 {sz} route")
        check(got.shape == (nfz, sz // 2) and s < -80.0 and s64 < -60.0,
              f"B12 {sz}/{hp} vs twin and float64")
        check(launches_z == 1 and bool(torch.equal(via, got)),
              f"B12 {sz}/{hp} through stft_mags_device")
        if name is None:
            return
        frames_z = kpv.hop_frames(wav, sz, hp, nfz) * w_d[None, :]
        record(name, "melonix_tpu_torch/csrc/stft_mag_sizes.cu",
               "melonix_tpu/kernels/pallas_stft.py:106", e,
               lambda: kstft.stft_mag(wav, w_d, sz, hp, nfz),
               lambda: kstft.stft_mag_plain(wav, w_d, sz, hp, nfz),
               lambda: torch.fft.rfft(frames_z),
               4 * (min(n, (nfz - 1) * hp + sz) + sz + nfz * sz // 2),
               fft_flops(nfz, sz),
               fn_graph=(lambda: kstft.stft_mag(wav, w_d, sz, hp, nfz))
               if way == "tile" else None)
        rows[name]["launches"] = launches_z

    song_d, song_np = wav, x
    for sz, hp, way, name in (
            (4096, 1024, "pair", "stft_mag_sizes"),
            (1024, 256, "pair", "stft_mag_sizes_1024"),
            (8192, 1024, "pair", "stft_mag_sizes_8192"),
            (512, 128, "pair", "stft_mag_sizes_512"),
            (1536, 384, "tile", "stft_mag_sizes_tile_1536"),
            (2560, 640, "tile", None), (24576, 3072, "tile", None),
            (48640, 9728, "tile", None), (49152, 6144, "tile", None),
            (16384, 2048, "large", "stft_mag_sizes_large_16384"),
            (32768, 4096, "large", "stft_mag_sizes_large_32768")):
        b12_check(sz, hp, num_frames(n, sz, hp), way, name, 10)
    # the frame tile at a frame count that is no multiple of its T (4 at
    # 1536): the last CTA takes fewer frames
    nf1536 = num_frames(n, 1536, 384) - 1
    nf1536 -= nf1536 % 4 == 0
    check(kstft.frame_tile(1536)["t"] == 4 and nf1536 % 4 != 0,
          "B12 1536 frame count against T")
    b12_check(1536, 384, nf1536, "tile", None, 10)
    # fft_large.cuh's and the frame tile's loads at their edges: frames
    # past the end of a 1500-sample track, a view whose data is not 16-byte
    # aligned (B12's hops are multiples of 128); B7 columns before 0 and
    # past n, on the track and on a misaligned view
    edge_ends = lambda sz: put(np.array(  # noqa: E731
        [5, sz // 3, sz + 7, n - 3, n + sz // 2, n + sz + 100, 0, 1],
        np.int32))
    for sz in (3072,) + kstft.LARGE_SIZES:  # the frame tile's load too
        w_e, e_e = put(hann_window(sz)), edge_ends(sz)
        for label, got, want in [
                (f"B12 {label_}", kstft.stft_mag(src, w_e, sz, hp, nf),
                 kstft.stft_mag_plain(src, w_e, sz, hp, nf))
                for label_, src, hp, nf in (
                    ("1500-sample track", wav[:1500], sz // 8, 3),
                    ("offset view", wav[3:], sz // 8, 40))] + [
                (f"B7 {label_} (columns before 0 and past n)",
                 kcols.spectrogram_columns_fused(src, e_e - span, e_e, kgain,
                                                 size=sz, colormap=False),
                 kcols.spectrogram_columns_plain(src, e_e - span, e_e, kgain,
                                                 size=sz, colormap=False))
                for label_, src in (("track", wav), ("offset view", wav[1:]))]:
            torch.cuda.synchronize()
            s = snr_db(got, want)
            print(f"    {label} at {sz}: SNR {s:.1f} dB against the twin (bar "
                  f"< -100), finite {bool(torch.isfinite(got).all())}",
                  flush=True)
            check(s < -100.0 and bool(torch.isfinite(got).all()),
                  f"{label} at {sz}")
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
        build = lambda sz_=sz, hp_=hp: mt.SpecPyramid(  # noqa: E731
            wav, size=sz_, base_hop=hp_)
        build_ms = host_ms(build)
        with plain_twins(*twins):
            build_plain_ms = host_ms(build)
        print(f"    SpecPyramid {sz}/{hp} build (wall, synchronised, median "
              f"of {REPS}): {build_ms:.2f} ms with the kernels, "
              f"{build_plain_ms:.2f} ms all-plain | {card}", flush=True)
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
        b7_dev = sum(v for k, v in by_name.items() if "columns_large" in k)
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
    ac_k2, w_k2 = b8()
    torch.cuda.synchronize()
    s, e_w = snr_db(ac_k, ac_p), max_err(w_k, w_p)
    same = bit_equal((ac_k2, w_k2), (ac_k, w_k))
    worst, exact0, n_sil = per_frame_bar(ac_k, ac_p, w_p)
    print(f"[12] B8 pitch_ac ({pnf} x {pframe}): ac SNR {s:.1f} dB (bar < "
          f"-100), max abs err {max_err(ac_k, ac_p):.3e}; w max abs err "
          f"{e_w:.3e} (bar 1e-5); per frame max |err| / (1e-5 ac[0]) "
          f"{worst:.4f} (bar 1), {n_sil} silent frames exactly 0 {exact0}; "
          f"two calls bit-equal {same}", flush=True)
    check(ac_k.shape == w_k.shape == (pnf, pframe) and s < -100.0
          and e_w < 1e-5, "B8 vs twin")
    check(worst <= 1.0 and exact0 and same, "B8 per frame on the song")
    # yardstick: cuFFT's round trip on the twin's mean-subtracted frames
    # (rfft, |.|^2, irfft: two FFT calls and one elementwise pass)
    record("pitch_ac", "melonix_tpu_torch/csrc/pitch_ac.cu",
           "melonix_tpu/kernels/pallas_pitch.py:123", max_err(ac_k, ac_p),
           b8, b8p,
           lambda: torch.fft.irfft(torch.fft.rfft(w_p, n=2 * pframe).abs()
                                   .square(), n=2 * pframe),
           4 * min(n, (pnf - 1) * phop + pframe) + nbytes(ac_k, w_k),
           2 * fft_flops(pnf, 2 * pframe))
    del ac_k, w_k, ac_p, ac_k2, w_k2

    # the level-stepped fixture: 100 dB between the frames of a pair
    # (its own names: the timed lambdas above hold ac_p and w_p)
    lv = make_level_steps(SR, SECONDS, phop)
    lv_d = torch.from_numpy(lv).to(dev)
    lnf = 1 + (len(lv) - pframe) // phop
    lv_k = kpitch.pitch_ac(lv_d, pframe, phop, lnf)
    lac_p, lw_p = kpitch.pitch_ac_plain(lv_d, pframe, phop, lnf)
    lv_k2 = kpitch.pitch_ac(lv_d, pframe, phop, lnf)
    torch.cuda.synchronize()
    e_w = max_err(lv_k[1], lw_p)
    same = bit_equal(lv_k2, lv_k)
    worst, exact0, n_sil = per_frame_bar(lv_k[0], lac_p, lw_p)
    print(f"    level-stepped fixture ({lnf} frames, odd; levels {LEVELS} "
          f"per 0.5 s): per frame max |err| / (1e-5 ac[0]) {worst:.4f} (bar "
          f"1), {n_sil} silent frames exactly 0 {exact0}; w max abs err "
          f"{e_w:.3e} (bar 1e-5); two calls bit-equal {same}", flush=True)
    check(lnf % 2 == 1 and n_sil > 0 and worst <= 1.0 and exact0
          and e_w < 1e-5 and same, "B8 per frame on the level-stepped fixture")
    del lv_k, lv_k2, lac_p, lw_p

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
    kpitch.pitch_ac.launches = 0
    curve = mt.pitch_curve(lv, SR)
    torch.cuda.synchronize()
    lv_launches = kpitch.pitch_ac.launches
    with plain_twins(*twins):
        curve_p = mt.pitch_curve(lv, SR)
    same_v, same_n = curves_agree(curve, curve_p)
    print(f"    pitch_curve of the level-stepped fixture ({len(curve.f0)} "
          f"frames, {100 * curve.voiced.mean():.2f}% voiced) vs the "
          f"all-plain run: voicing equal on {100 * same_v:.3f}%, notes "
          f"within 0.01 st on {100 * same_n:.3f}% (bars 99.9); B8 launches "
          f"{lv_launches} (bar 1)", flush=True)
    check(same_v >= 0.999 and same_n >= 0.999 and lv_launches == 1,
          "pitch_curve of the level-stepped fixture vs all-plain")
    del lv_d

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
    both_routes("B3 (mag, phi)",
                lambda route: kpv.synth_ola_phase(*b3f_args, cart=False,
                                                  route=route),
                (y_k, r_k, pl_k, p0_k),
                lambda: kpv.phase_scan(mag_m, phi_m, da_d, 0, fr_m, zeros,
                                       zeros, zeros, size, hop, cart=False),
                lambda: torch.fft.irfft(spec_b3f, n=size))
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
        both_routes(
            f"B3 lock=True {entry}",
            lambda route, args=args, cart=cart: kpv.synth_ola_phase(
                *args, cart=cart, lock=True, route=route),
            (y_k, r_k, pl_k, p0_k),
            lambda args=args, cart=cart: kpv.phase_scan(
                *args[:3], *args[4:], cart=cart, lock=True),
            lambda: torch.fft.irfft(spec_b3, n=size))
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
                   4 * covered_len(s9, s9 + sz, n) + nbytes(st_sz, got), 0.0,
                   fn_graph=b9)
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
    torch.cuda.synchronize()
    check(torch.equal(got, want), "B11 over the whole padded output vs twin")

    # The zero-copy read (kres.LerpReader: one launch into mapped host
    # memory, one wait) against the twin over the window's covering blocks
    def read_vs_twin(s_r, n_r):
        j_r = s_r._j
        got_r = s_r.read(n_r)
        hi_r = min(j_r + n_r, s_r.n_out)
        b0, b1 = j_r // kres.BLK, -(-hi_r // kres.BLK)
        want_r = kres.resample_lerp_plain(
            s_r._y_norm, s_r._pos[b0 * kres.BLK : b1 * kres.BLK],
            s_r._base[b0:b1], s_r._rows)[j_r - b0 * kres.BLK :
                                         hi_r - b0 * kres.BLK]
        return (j_r, hi_r - j_r, np.array_equal(got_r[: hi_r - j_r],
                                                want_r.cpu().numpy())
                and not got_r[hi_r - j_r :].any())

    kres.resample_lerp.launches = 0
    windows = []
    for start_sec, sizes in ((0.0, (1024, 2048, 32768)),
                             (60.0, (1024, 2048, 32768)),  # mid-block
                             ((plan.n_out - 3000) / SR, (32768,))):
        s_w = mt.PvStream(wav, knots, start_sec=start_sec)
        windows += [read_vs_twin(s_w, n_r) for n_r in sizes]
        if start_sec > 60.0:
            check(s_w.exhausted, "the final odd block's read did not end "
                  "the stream")
    torch.cuda.synchronize()
    check(plan.n_out % kres.BLK != 0
          and sum(windows[-1][:2]) == plan.n_out,
          "the last window does not end the final odd block")
    print("     B11 zero-copy reads vs twin over the same window (bars: "
          "equal; launches = reads): "
          + ", ".join(f"[{j_r}, +{m_r}) {ok}" for j_r, m_r, ok in windows)
          + f"; B11 launches {kres.resample_lerp.launches}; whole padded "
          f"output ({pos_n.shape[0]} samples, kres.resample_lerp) equal "
          f"True; slab rows {rows_n}", flush=True)
    check(all(ok for *_, ok in windows)
          and kres.resample_lerp.launches == len(windows),
          "B11 zero-copy read vs twin")

    # One 1024-sample read across a block boundary mid-song: the launcher
    # alone (the row's kernel time) and the whole read (launch, wait, copy),
    # timed in phase 22
    rd = strm._reader
    j_mid = (plan.n_out // 2) // kres.BLK * kres.BLK
    j_w = j_mid + kres.BLK - 512
    pos_r, base_r = pos_n[j_mid : j_mid + 2 * kres.BLK], base_n[
        j_mid // kres.BLK : j_mid // kres.BLK + 2]
    w0 = j_w - j_mid  # the window's offset in its two blocks
    b11 = lambda: rd.launch(j_w, 1024)  # noqa: E731
    b11_read = lambda: rd.read(j_w, 1024)  # noqa: E731
    b11p = lambda: kres.resample_lerp_plain(  # noqa: E731
        y_n, pos_r, base_r, rows_n)[w0 : w0 + 1024]
    got_r, want_r = b11_read().copy(), b11p()
    check(np.array_equal(got_r, want_r.cpu().numpy()),
          "B11 timed read vs twin")
    b11_full = lambda: kres.resample_lerp(y_n, pos_n, base_n, rows_n)  # noqa: E731

    def tap_bytes(pos_t, base_t):
        """4 bytes for each distinct source sample the lerp touches."""
        i0 = (base_t.long().repeat_interleave(kres.BLK)[: pos_t.shape[0]]
              + torch.floor(pos_t).clamp(0, rows_n * 128 - 2).long())
        return 4 * int(torch.unique(torch.cat([i0, i0 + 1])).numel())

    # the bytes one read needs: its positions and bases, the taps it
    # touches, its output
    pos_w = pos_n[j_w : j_w + 1024]
    i0_w = (base_r.long().repeat_interleave(kres.BLK)[w0 : w0 + 1024]
            + torch.floor(pos_w).clamp(0, rows_n * 128 - 2).long())
    w_bytes = (4 * int(torch.unique(torch.cat([i0_w, i0_w + 1])).numel())
               + nbytes(pos_w, base_r, want_r))
    record("resample_lerp", "melonix_tpu_torch/csrc/resample_lerp.cu",
           "melonix_tpu/kernels/pallas_resample.py:248",
           max_err(torch.from_numpy(got_r).to(dev), want_r), b11, b11p, None,
           w_bytes, 0.0, fn_graph=b11)
    rows["resample_lerp"]["launches"] = b11_launches
    full_bound, _by = bound(tap_bytes(pos_n, base_n)
                            + nbytes(pos_n, base_n, got), 0.0)
    rows["resample_lerp"]["full_bound_ms"] = full_bound
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
    both_routes("B10", lambda route: kpv.synth_ola(mag10, psi10, win, size,
                                                   hop, route=route),
                got, None, lambda: torch.fft.irfft(spec_b10, n=size))
    # the pair synthesis's edges: a hop that is no multiple of 128 (the
    # fused route at 441), an odd frame count (the last frame paired with a
    # zero spectrum) and one frame, each against the twin
    f10 = mag10.shape[0]
    for label, hp_, nf_ in (("hop 441", 441, f10),
                            ("odd count", hop, f10 - 1 + f10 % 2),
                            ("one frame", hop, 1)):
        g_ = kpv.synth_ola(mag10[:nf_], psi10[:nf_], win, size, hp_)
        w_ = kpv.synth_ola_plain(mag10[:nf_], psi10[:nf_], win, size, hp_)
        u_ = kpv.synth_ola(mag10[:nf_], psi10[:nf_], win, size, hp_,
                           route="frames")
        torch.cuda.synchronize()
        s_ = snr_db(g_, w_)
        print(f"     B10 synth_ola, {label} ({nf_} frames, hop {hp_}, "
              f"{kpv.ola_route(hp_)} route): SNR {s_:.1f} dB (bar < -100), "
              f"vs the frames route bit-equal {torch.equal(g_, u_)} (bar: "
              f"equal)", flush=True)
        check(g_.shape == ((nf_ - 1) * hp_ + size,) and s_ < -100.0
              and torch.equal(g_, u_), f"B10 {label} vs twin")
    record("pv_synth_ola", "melonix_tpu_torch/csrc/pv_synth_ola.cu",
           "melonix_tpu/kernels/pallas_pv.py:492", e, b10, b10p,
           lambda: torch.fft.irfft(spec_b10, n=size),
           nbytes(mag10, psi10, win, got), fft_flops(mag10.shape[0], size))
    del got, want

    # -- 19. B7 and B12 above 49,152 points ---------------------------
    # 65,536 points on fft_large.cuh's 2-CTA cluster; B7's other sizes, 1024
    # j for j = 49 .. 63, on fft_mixed.cuh's 2-CTA cluster, every one held
    # (50,176, 57,344 and 64,512 timed); B12's four-step route in coalesced
    # tiles (98,304 = 3 x 2^15, 131,072 and 1,048,576 points); its Bluestein
    # columns on 2-CTA clusters (512 x 12,289) and on 4-CTA clusters (512 x
    # 16,411, 16,385 and 32,749); above N2 = 32,768 through device scratch
    # (512 x 32,771 on the song, 512 x 65,537 on the song tiled four times,
    # so both frames hold signal)
    timed_b7 = {65536: "spectrogram_columns_65536",
                50176: "spectrogram_columns_cluster_50176",
                57344: "spectrogram_columns_cluster_57344",
                64512: "spectrogram_columns_cluster_64512"}
    for big in [65536] + [1024 * j for j in range(49, 64)]:
        way = "large" if big == 65536 else "cluster"
        ends_b = np.linspace(big // 2, n - 1, 64).astype(np.int64)
        b7_check(big, way, "64 columns", ends_b - span, ends_b, 19)
        launches_b = b7_oracle(big, np.linspace(big, n - 1, 12).astype(
            np.int64), 19)
        if big in timed_b7:
            b7_row(timed_b7[big], big, ends_b - span, ends_b, launches_b)
    for sz, hp, way, name in (
            (65536, 8192, "large", "stft_mag_sizes_large_65536"),
            (98304, 12288, "four_step", "stft_mag_sizes_four_step_98304"),
            (131072, 16384, "four_step", "stft_mag_sizes_four_step_131072"),
            (1 << 20, 131072, "four_step",
             "stft_mag_sizes_four_step_1048576")):
        b12_check(sz, hp, num_frames(n, sz, hp), way, name, 19)
    x4 = np.tile(x, 4)
    tiled = (put(x4), x4)
    for n2, way, ctas, name, track in (
            (12289, "bluestein", 2, "stft_mag_sizes_bluestein", None),
            (16411, "bluestein", 4, "stft_mag_sizes_bluestein_4cta", None),
            (16385, "bluestein", 4, "stft_mag_sizes_bluestein_4cta_16385",
             None),
            (32749, "bluestein", 4, "stft_mag_sizes_bluestein_4cta_32749",
             None),
            (32771, "bluestein_scratch", None,
             "stft_mag_sizes_bluestein_scratch", None),
            (65537, "bluestein_scratch", None,
             "stft_mag_sizes_bluestein_scratch_65537", tiled)):
        odd = 512 * n2  # N1 512, N2 prime
        check(kstft.four_step_plan(odd) == (512, n2), f"B12 512 x {n2} plan")
        check(ctas is None or kstft.bluestein_cluster(n2) == ctas,
              f"B12 512 x {n2} cluster")
        b12_check(odd, odd // 4, 2, way, name, 19, track)
    del tiled, x4

    # -- 20. two ranks on gloo, each on this card ----------------------
    rk20, seq20 = run_ranks(2, "gloo")
    # The reference: the same formulas with the phase sum formed exactly
    # (float64, rounded once), held in the JAX suite's quarter-second form
    # at its bars (test_parallel.py:219-231), both the seq-parallel PV and
    # the single render (B3's blocked scan sums in float64 too).  The seq
    # PV is also held to the single render in this script's peak form (2e-3
    # of max, 2e-2) and read in both forms.
    exact = pv_sum_order_render(mt, x, bench_markers(mt, n), dev)
    want = out.cpu().numpy()  # render_track_pv of the song on the card
    rms_1, env_1 = rms_rel_env(want, exact, SR)
    print(f"[20] render_track_pv vs the exact phase sum: rms {rms_1:.3e} of "
          f"rms (bar 2e-3), envelope {env_1:.3e} (bar 2e-2)", flush=True)
    check(rms_1 < 2e-3 and env_1 < 2e-2, "render_track_pv vs exact sum")
    rank_checks("[20]", rk20, seq20, want, exact, card,
                "gloo ranks (each rank on cuda:0, payloads staged through "
                "host memory)")
    rows["pv_synth_ola"]["launches"] = rk20[0]["seq_pv"]["launches"][
        "synth_ola"]

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
    takes = tempfile.TemporaryDirectory()  # phase 21's takes, for 27 too
    cli_batch_takes(mt, x, takes.name)

    # -- 22. times (CUDA events, median of 5 after a warm-up) ---------
    for r in rows.values():
        inner = r.pop("inner", KERNEL_INNER)
        r["ms"] = cuda_ms(r.pop("run_kernel"), inner=inner)
        r["plain_ms"] = cuda_ms(r.pop("run_plain"), inner=inner)
        lib = r.pop("run_library")
        r["library_ms"] = (None if lib is None else cuda_ms(lib, inner=inner))
        lib_txt = ("none" if lib is None
                   else f"{r['library_ms']:.4f} ms")
        g = r.pop("run_graph")
        if g is not None:
            r["device_ms"] = graph_ms(g, inner=inner)
        dev_txt = ("" if g is None else f" (device alone, one CUDA graph of "
                   f"the {inner} calls: {r['device_ms']:.4f} ms)")
        print(f"[22] {r['name']}: kernel {r['ms']:.4f} ms{dev_txt}, plain "
              f"twin {r['plain_ms']:.4f} ms, one PyTorch call {lib_txt}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); launches on its "
              f"main path {r['launches']} (mean of {inner} "
              f"back-to-back calls) | {card}", flush=True)

    # B4's render tail with its one packed upload; B11's whole read (launch,
    # wait, samples in NumPy) and its whole padded output
    def k_ms(fn):
        return cuda_ms(fn, inner=KERNEL_INNER)

    r4, r11 = rows["resample_pv"], rows["resample_lerp"]
    glue_ms = k_ms(lambda: pv._resample_pv_fused(plan, y))
    print(f"[22] B4 the render's tail with its one upload {glue_ms:.4f} ms; "
          f"kernel {r4['ms']:.4f} ms, bound {r4['bound_ms']:.4f} ms | {card}",
          flush=True)
    r11["read_ms"] = k_ms(b11_read)
    r11["full_ms"] = k_ms(b11_full)
    r11["full_device_ms"] = graph_ms(b11_full)
    print(f"[22] B11 a 1024-sample read: the launch {r11['ms']:.4f} ms, the "
          f"whole read (launch, wait, samples in NumPy) {r11['read_ms']:.4f} "
          f"ms; over the whole padded output ({pos_n.shape[0]} samples) "
          f"{r11['full_ms']:.4f} ms, device alone "
          f"{r11['full_device_ms']:.4f} ms, bound {r11['full_bound_ms']:.4f} "
          f"ms (bytes) | {card}", flush=True)
    cumsum32_ms = cuda_ms(lambda: torch.cumsum(incr_sc, dim=0),
                          inner=KERNEL_INNER)
    print(f"[22] B3's phase scan yardsticks: torch.cumsum of the "
          f"{tuple(incr_sc.shape)} increments {cumsum32_ms:.4f} ms in float32, "
          f"{rows['pv_phase_scan']['library_ms']:.4f} ms in float64; B3's "
          f"synthesis + OLA launches (B3 less the scan alone) "
          f"{rows['pv_synth_ola_phase']['ms'] - rows['pv_phase_scan']['ms']:.4f}"
          f" ms | {card}", flush=True)
    for label, fused, frames, scan, lib in route_rows:
        # in turns: fused, frames, frames, fused
        f1, u1, u2, f2 = (cuda_ms(fn, inner=KERNEL_INNER)
                          for fn in (fused, frames, frames, fused))
        f_ms, u_ms = (f1 + f2) / 2, (u1 + u2) / 2
        lib_ms = cuda_ms(lib, inner=KERNEL_INNER)
        less = ""
        if scan is not None:
            s_ms = cuda_ms(scan, inner=KERNEL_INNER)
            less = (f"; less the scan alone ({s_ms:.4f} ms), synthesis + "
                    f"OLA: fused {f_ms - s_ms:.4f} ms, frames "
                    f"{u_ms - s_ms:.4f} ms")
        print(f"[22] {label} overlap-add routes (mean of two turns each): "
              f"fused {f_ms:.4f} ms ({f1:.4f}, {f2:.4f}), frames "
              f"{u_ms:.4f} ms ({u1:.4f}, {u2:.4f}){less}; irfft of its "
              f"half spectra {lib_ms:.4f} ms | {card}", flush=True)
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
          f"{g_fix_ms:.2f} ms + device part (uploads, B5 + B6, fixes) "
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

    # -- 23. the file slice ------------------------------------------
    t23 = time.perf_counter()
    file_slice(mt, x, card, root)
    print(f"[23] file slice {time.perf_counter() - t23:.1f} s", flush=True)

    # -- 24. the editor ---------------------------------------------
    t24 = time.perf_counter()
    editor_slice(mt, x, card, root, twins)
    print(f"[24] editor {time.perf_counter() - t24:.1f} s", flush=True)

    # -- 25. the warm-up at open ---------------------------------------
    t25 = time.perf_counter()
    first_use_phase(card, root)
    print(f"[25] warm-up at open {time.perf_counter() - t25:.1f} s",
          flush=True)

    # -- 26. the first two-chunk PV render -------------------------------
    t26 = time.perf_counter()
    two_chunk_render(mt, pv, twins, card)
    print(f"[26] two-chunk render {time.perf_counter() - t26:.1f} s",
          flush=True)

    # -- 27. every card: the launcher, NCCL, the CLI's batch --------------
    t27 = time.perf_counter()
    every_card_phase(mt, x, card, root, takes.name, want, exact, rk20)
    takes.cleanup()
    print(f"[27] every card {time.perf_counter() - t27:.1f} s; "
          f"chip_smoke.py {time.perf_counter() - t_start:.1f} s in all",
          flush=True)

    print(card)  # the card's name and power limit, near the end again
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def every_card_main() -> int:
    """``chip_smoke.py --every-card``: phase 27 alone, for a machine with
    several cards (the build, phase 21's takes and CLI batch, and the
    single-card references phase 27 holds the ranks to; no gloo figures
    beside them)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import melonix_tpu_torch as mt
    from melonix_tpu_torch.kernels import _build
    from melonix_tpu_torch.runtime import native

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    check(native.try_load() is not None, "native host runtime: no compiler")
    print(f"[2] built in {time.perf_counter() - t0:.1f} s | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    x = make_song(SR, SECONDS)
    want = mt.render_track_pv(x, mt.MapKnots.from_markers(
        bench_markers(mt, len(x)), SR, len(x)), device=dev)
    exact = pv_sum_order_render(mt, x, bench_markers(mt, len(x)), dev)
    with tempfile.TemporaryDirectory() as takes:
        cli_batch_takes(mt, x, takes)
        every_card_phase(mt, x, card, root, takes, np.asarray(want), exact)
    print(f"[27] every card: chip_smoke.py --every-card "
          f"{time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 1:
        sys.exit(main())
    if sys.argv[1] == "--every-card":
        sys.exit(every_card_main())
    sys.exit(first_use_main(sys.argv[1:]) if sys.argv[1] == "--first-use"
             else rank_main(sys.argv[1:]))

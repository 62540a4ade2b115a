#!/usr/bin/env python3
"""Smoke run of melonix_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``melonix_tpu_torch/csrc`` and the
native host runtime from ``native/melonix_native.cpp``, holds each kernel
against its plain PyTorch twin on the card at the main paths' shapes, drives
the two main paths once each on a 180 s, 44.1 kHz song with 12 markers (the
2048/512 |STFT| plus the phase-vocoder render; the granular export,
``render_track``), checks their output (the granular export bit for bit
against its plain references and ``tests/oracle.py``), shows that each run
went through every kernel of its path, and times kernels, twins and paths.
Any failed check raises: the script then exits non-zero and prints no
result.  The last line of standard output is

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
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 44100
SECONDS = 180.0
REPS = 5  # timed repetitions after one warm-up; the median is reported
KERNEL_INNER = 10  # back-to-back calls per timed kernel repetition


def make_song(sr: int, seconds: float) -> np.ndarray:
    """Two vibrato partials + noise (the JAX bench's song, bench.py:88-94)."""
    t = np.arange(int(sr * seconds)) / sr
    f = 220.0 * 2.0 ** (np.sin(2 * np.pi * 0.25 * t) * 0.5)
    x = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr)
    x += 0.2 * np.sin(2 * np.pi * 2.0 * np.cumsum(f) / sr)
    x += 0.01 * np.random.default_rng(0).standard_normal(len(t))
    return x.astype(np.float32)


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
def plain_twins(kpv, kres, krender):
    """Route the main paths through the plain twins (for the all-plain
    reference runs on the card); restores the kernels on exit."""
    saved = (kpv.stft_mag, kpv.analysis, kpv.synth_ola_phase,
             kres.resample_pv, krender.render_steps, krender.compact)
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
         kres.resample_pv, krender.render_steps, krender.compact) = saved


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


def pitch_err_cents(mt, dev) -> float:
    """End-to-end PV pitch accuracy (bench.py:185-223): a 440 Hz tone through
    a +2-semitone plateau, dominant frequency of the output at the plateau
    from a 32768-pt reference column (computed on the host) with parabolic
    bin refinement, in cents against 440 * 2^(2/12)."""
    n = 5 * SR
    t = np.arange(n) / SR
    tone = (0.5 * np.sin(2.0 * np.pi * 440.0 * t)).astype(np.float32)
    knots = mt.MapKnots.from_markers(
        [mt.Marker(n // 3, 57.0, 0.0, 2.0),
         mt.Marker(2 * n // 3, 57.0, 0.0, 2.0)], SR, n)
    out = mt.render_track_pv(tone, knots, device=dev)
    size = 32768
    end = n // 2
    start = end - int(0.05 * SR)
    # spec.cpp:44-66: end-anchored frame, exp decay before start, |X|/size
    idx = np.arange(end - size, end)
    frame = np.where((idx >= 0) & (idx < len(out)),
                     out[np.clip(idx, 0, len(out) - 1)].astype(np.float64), 0.0)
    dist = (start - idx).astype(np.float64)
    frame *= np.where(dist > 0, np.exp(-2.5e-4 * dist), 1.0)
    col = np.abs(np.fft.fft(frame)[: size // 2]) / size
    k = 1 + int(np.argmax(col[1 : size // 2 - 1]))
    ym1, y0, yp1 = col[k - 1], col[k], col[k + 1]
    denom = ym1 - 2 * y0 + yp1
    dk = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-12 else 0.0
    f_got = (k + float(np.clip(dk, -0.5, 0.5))) * SR / size
    return float(1200.0 * np.log2(f_got / (440.0 * 2.0 ** (2.0 / 12.0))))


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
    from melonix_tpu_torch.engine.spectral import hann_window, num_frames
    from melonix_tpu_torch.kernels import _build
    from melonix_tpu_torch.kernels import pv as kpv
    from melonix_tpu_torch.kernels import render as krender
    from melonix_tpu_torch.kernels import resample as kres
    from melonix_tpu_torch.runtime import native

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

    def record(name, source, replaces, err, fn_k, fn_p):
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=replaces, launches=0, max_abs_err=err,
                          run_kernel=fn_k, run_plain=fn_p)

    b1 = lambda: kpv.stft_mag(wav, win, size, hop, nf)  # noqa: E731
    b1p = lambda: kpv.stft_mag_plain(wav, win, size, hop, nf)  # noqa: E731
    got, want = b1(), b1p()
    torch.cuda.synchronize()
    s = snr_db(got, want)
    print(f"[3] B1 stft_mag: SNR {s:.1f} dB (bar < -100), max abs err "
          f"{max_err(got, want):.3e}", flush=True)
    check(got.shape == (nf, size // 2) and s < -100.0, "B1 vs twin")
    record("stft_mag", "melonix_tpu_torch/csrc/stft_mag.cu",
           "melonix_tpu/kernels/pallas_pv.py:381", max_err(got, want), b1, b1p)

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
    record("pv_analysis", "melonix_tpu_torch/csrc/pv_analysis.cu",
           "melonix_tpu/kernels/pallas_pv.py:240", e, b2, b2p)

    b3_args = (re_k, im_k, da, win, 0, f_real, zeros, zeros, zeros, size, hop)
    b3 = lambda: kpv.synth_ola_phase(*b3_args)  # noqa: E731
    b3p = lambda: kpv.synth_ola_phase_plain(*b3_args)  # noqa: E731
    (y_k, r_k, pl_k, p0_k), (y_p, r_p, pl_p, p0_p) = b3(), b3p()
    torch.cuda.synchronize()
    rms, env = rms_env(y_k, y_p)
    e = max_err(y_k, y_p)
    r_ok = float(((r_k - r_p).abs() < 1e-2).float().mean())
    print(f"    B3 synth_ola_phase: rms {rms:.2e} (bar < 5e-3 of max), "
          f"envelope {env:.2e} (bar < 2e-2), max abs err {e:.3e}; carries: "
          f"phi0_eff {max_err(p0_k, p0_p):.2e}, phi_last "
          f"{max_err(pl_k, pl_p):.2e} (bars 1e-5), resid_last within 1e-2 "
          f"on {100 * r_ok:.1f}% of bins (bar 90%)", flush=True)
    check(y_k.shape == y_p.shape == ((plan.n_frames - 1) * hop + size,),
          "B3 output length")
    check(rms < 5e-3 and env < 2e-2, "B3 waveform vs twin")
    check(max_err(p0_k, p0_p) < 1e-5 and max_err(pl_k, pl_p) < 1e-5
          and r_ok > 0.9, "B3 carries vs twin")
    record("pv_synth_ola_phase", "melonix_tpu_torch/csrc/pv_synth_ola_phase.cu",
           "melonix_tpu/kernels/pallas_pv.py:828", e, b3, b3p)
    # a later chunk: global frame offset, padded tail, carries from above
    m0_late, f_late = 3 * plan.n_frames, plan.n_frames - 17
    late = (re_k, im_k, da, win, m0_late, f_late, p0_p, r_p, pl_p, size, hop)
    lk, lp = kpv.synth_ola_phase(*late), kpv.synth_ola_phase_plain(*late)
    torch.cuda.synchronize()
    rms, env = rms_env(lk[0], lp[0])
    r_ok = float(((lk[1] - lp[1]).abs() < 1e-2).float().mean())
    e_pl, e_p0 = max_err(lk[2], lp[2]), max_err(lk[3], lp[3])
    print(f"    B3 later chunk (m0 {m0_late}, f_real {f_late}): rms {rms:.2e}, "
          f"envelope {env:.2e}, phi0_eff {e_p0:.2e}, phi_last {e_pl:.2e}, "
          f"resid_last within 1e-2 on {100 * r_ok:.1f}% of bins (same bars)",
          flush=True)
    check(rms < 5e-3 and env < 2e-2 and e_p0 < 1e-5 and e_pl < 1e-5
          and r_ok > 0.9, "B3 later chunk")

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
           "melonix_tpu/kernels/pallas_resample.py:202", e, b4, b4p)

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
    with plain_twins(kpv, kres, krender):
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
    # remains is the running float32 phase sum's rounding, which a
    # different grouping of 15k terms exposes: the PV bars apply.
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
    for name, fn in zip(rows, counters):
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
    record("render_steps", "melonix_tpu_torch/csrc/render_steps.cu",
           "melonix_tpu/kernels/pallas_render.py:108", e, b5, b5p)
    b6 = lambda: krender.compact(vals_k, off_d, a0g_d, cntg_d, total)  # noqa: E731
    b6p = lambda: krender.compact_plain(vals_k, off_d, total)  # noqa: E731
    got, want = b6(), b6p()
    torch.cuda.synchronize()
    e = max_err(got, want)
    print(f"    B6 compact ({total} samples): equal {torch.equal(got, want)}, "
          f"max abs err {e:.3e} (bar: equal)", flush=True)
    check(got.shape == (total,) and torch.equal(got, want), "B6 vs twin")
    record("compact", "melonix_tpu_torch/csrc/compact.cu",
           "melonix_tpu/kernels/pallas_render.py:375", e, b6, b6p)
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
    with plain_twins(kpv, kres, krender):
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

    # -- 9. times (CUDA events, median of 5 after a warm-up) ----------
    for r in rows.values():
        r["ms"] = cuda_ms(r.pop("run_kernel"), inner=KERNEL_INNER)
        r["plain_ms"] = cuda_ms(r.pop("run_plain"), inner=KERNEL_INNER)
        print(f"[9] {r['name']}: kernel {r['ms']:.4f} ms, plain twin "
              f"{r['plain_ms']:.4f} ms (mean of {KERNEL_INNER} back-to-back "
              f"calls) | {card}", flush=True)
    dev_args = (wav, gplan.grain_start, gplan.rate, gplan.sz, offs, total,
                fix_idx, fix_val, szmax)
    g_dev_ms = cuda_ms(lambda: krender.render_full(*dev_args))
    with plain_twins(kpv, kres, krender):
        g_dev_plain_ms = cuda_ms(lambda: krender.render_full(*dev_args))
    g_wall_ms = host_ms(granular)
    g_grains_ms = host_ms(lambda: mt.build_grain_table(x))
    g_plan_ms = host_ms(lambda: mt.build_render_plan(table, knots))
    g_fix_ms = host_ms(lambda: grender.seam_fixes(gplan, x, total))
    print(f"[9] granular path ({SECONDS:.0f} s): wall {g_wall_ms:.2f} ms = "
          f"host grains {g_grains_ms:.2f} + plan {g_plan_ms:.2f} + seam fixes "
          f"{g_fix_ms:.2f} ms + device part (uploads, B5, B6, fixes) "
          f"{g_dev_ms:.3f} ms with the kernels, {g_dev_plain_ms:.3f} ms "
          f"all-plain | {card}", flush=True)
    path_ms = cuda_ms(pipeline)
    with plain_twins(kpv, kres, krender):
        plain_path_ms = cuda_ms(pipeline)
    print(f"[9] main path (|STFT| + PV render of {SECONDS:.0f} s, host plan "
          f"included): {path_ms:.2f} ms with the kernels, {plain_path_ms:.2f} "
          f"ms all-plain | {card}", flush=True)

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

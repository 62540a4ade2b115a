"""Command-line interface of the PyTorch/CUDA port.

    python -m melonix_tpu_torch render in.wav --markers m.json -o out.wav \
        [--engine pv [--formant] [--lock]] [--stereo] [--device cuda|cpu]
    python -m melonix_tpu_torch pitch in.wav -o curve.json \
        [--method nsdf|hps|hybrid] [--device cuda|cpu]
    python -m melonix_tpu_torch autotune in.wav -o tuned.wav \
        [--scale major --key c] [--engine granular] [--no-formant] \
        [--device cuda|cpu]

The render of a WAV file through the granular engine (the default) or the
phase vocoder (``--formant`` to keep the spectral envelope, ``--lock`` for
identity phase locking), mono or ``--stereo``, the pitch curve of a WAV file
as JSON, and its automatic pitch correction.  The flags and defaults are
those of ``melonix_tpu``'s subcommands of the same names, plus ``--device``
(default ``cuda``; there is no fallback to another device).  Flags whose
code is not ported yet exit with status 2 and name the ROADMAP item that
ports them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# flag -> ROADMAP queue A item that ports it
NOT_PORTED = {
    "rate": "item 9 (CLI render options: --rate)",
    "trace": "item 9 (CLI render options: --trace)",
}


def _not_wav(path: str) -> str | None:
    if not path.lower().endswith(".wav"):
        return f"{path}: only WAV input is ported (ROADMAP queue A, item 14)"
    return None


def _not_ported(args) -> str | None:
    for flag in NOT_PORTED:
        if getattr(args, flag):
            return f"--{flag}: " + NOT_PORTED[flag]
    return _not_wav(args.input)


def _refuse(missing: str) -> int:
    print(f"not ported yet: {missing} in ROADMAP.md queue A", file=sys.stderr)
    return 2


def _read_mono(path: str):
    from .io.audio import downmix_mono
    from .io.wav import read_wav

    wav, rate = read_wav(path)
    return downmix_mono(wav), rate


def cmd_render(args) -> int:
    from .engine.session import render_session
    from .io.audio import downmix_mono
    from .io.wav import read_wav, write_wav
    from .markers import markers_from_json

    missing = _not_ported(args)
    if missing is not None:
        return _refuse(missing)
    wav, rate = read_wav(args.input)
    if not args.stereo:
        wav = downmix_mono(wav)
    markers = []
    if args.markers:
        with open(args.markers) as f:
            markers = markers_from_json(f.read())
    t0 = time.perf_counter()
    out = render_session(wav, markers, rate, engine=args.engine,
                         preserve_formants=args.formant,
                         phase_locking=args.lock, device=args.device)
    dt = time.perf_counter() - t0
    write_wav(args.output, out, rate, dtype=args.dtype)
    ch = out.shape[1] if out.ndim == 2 else 1
    detail = ("phase-vocoder"
              + (" formant-preserving" if args.formant else "")
              + (" phase-locked" if args.lock else "")
              if args.engine == "pv" else "granular")
    print(
        f"rendered {len(out)/rate:.2f}s x{ch}ch @{rate}Hz "
        f"({len(markers)} markers, {detail} on {args.device}) "
        f"in {dt:.2f}s -> {args.output}"
    )
    return 0


def cmd_pitch(args) -> int:
    from .engine.pitch import pitch_curve

    missing = _not_wav(args.input)
    if missing is not None:
        return _refuse(missing)
    wav, rate = _read_mono(args.input)
    t0 = time.perf_counter()
    curve = pitch_curve(wav, rate, method=args.method, device=args.device)
    dt = time.perf_counter() - t0
    payload = {
        "sample_rate": int(rate),
        "hop": int(curve.hop),
        "f0_hz": [round(float(v), 3) for v in curve.f0],
        "voiced": [bool(v) for v in curve.voiced],
        "note": [round(float(v), 3) for v in curve.note],
    }
    with open(args.output, "w") as f:
        json.dump(payload, f)
    voiced_pct = 100.0 * np.mean(curve.voiced) if len(curve.voiced) else 0.0
    print(f"pitch: {len(curve.f0)} frames ({voiced_pct:.0f}% voiced) on "
          f"{args.device} in {dt:.2f}s -> {args.output}")
    return 0


def cmd_autotune(args) -> int:
    from .engine.autotune import autotune
    from .io.wav import write_wav
    from .markers import markers_to_json

    missing = _not_wav(args.input)
    if missing is not None:
        return _refuse(missing)
    wav, rate = _read_mono(args.input)
    t0 = time.perf_counter()
    out, markers = autotune(
        wav, rate, scale=args.scale, key=args.key, strength=args.strength,
        vibrato=args.vibrato, engine=args.engine,
        preserve_formants=not args.no_formant, device=args.device,
    )
    dt = time.perf_counter() - t0
    write_wav(args.output, out, rate, dtype=args.dtype)
    if args.markers_out:
        with open(args.markers_out, "w") as f:
            f.write(markers_to_json(markers))
    print(
        f"autotuned {len(out)/rate:.2f}s: {len(markers)} markers "
        f"({args.scale}/{args.key}, strength {args.strength}, {args.engine} "
        f"on {args.device}) in {dt:.2f}s -> {args.output}"
    )
    return 0


def _device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="melonix_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="offline render to WAV")
    r.add_argument("input")
    r.add_argument("--markers", help="markers JSON file")
    r.add_argument("-o", "--output", required=True)
    r.add_argument("--dtype", choices=["int16", "float32"], default="int16")
    r.add_argument(
        "--engine",
        choices=["granular", "pv"],
        default="granular",
        help="granular = reference-parity splicer; pv = phase vocoder",
    )
    r.add_argument("--trace", help="write a profiler trace to this directory")
    r.add_argument("--stereo", action="store_true", help="keep source channels")
    r.add_argument("--formant", action="store_true",
                   help="preserve the spectral envelope (pv engine only)")
    r.add_argument("--lock", action="store_true",
                   help="identity phase locking (pv engine only)")
    r.add_argument("--rate", type=int, help="resample the output to this rate")
    _device_flag(r)
    r.set_defaults(fn=cmd_render)

    t = sub.add_parser("pitch", help="batched pitch-curve extraction")
    t.add_argument("--method", choices=("nsdf", "hps", "hybrid"),
                   default="nsdf",
                   help="autocorrelation (nsdf), harmonic product spectrum, "
                        "or hybrid octave-vote")
    t.add_argument("input")
    t.add_argument("-o", "--output", required=True)
    _device_flag(t)
    t.set_defaults(fn=cmd_pitch)

    a = sub.add_parser("autotune", help="detect pitch, snap to scale, render")
    a.add_argument("input")
    a.add_argument("-o", "--output", required=True)
    a.add_argument("--scale", choices=["chromatic", "major", "minor"],
                   default="chromatic")
    a.add_argument("--key", default="a", help="key root (a, c#, bb, ...)")
    a.add_argument("--strength", type=float, default=1.0)
    a.add_argument("--vibrato", type=float, default=0.0,
                   help="0..1: flatten intra-note pitch modulation")
    a.add_argument("--engine", choices=["granular", "pv"], default="pv")
    a.add_argument("--no-formant", action="store_true")
    a.add_argument("--markers-out", help="also write the suggested markers JSON")
    a.add_argument("--dtype", choices=["int16", "float32"], default="int16")
    _device_flag(a)
    a.set_defaults(fn=cmd_autotune)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Command-line interface of the PyTorch/CUDA port.

    python -m melonix_tpu_torch render in.wav --markers m.json -o out.wav \
        [--engine pv [--formant] [--lock]] [--stereo] [--device cuda|cpu]
    python -m melonix_tpu_torch pitch in.wav -o curve.json \
        [--method nsdf|hps|hybrid] [--device cuda|cpu]
    python -m melonix_tpu_torch autotune in.wav -o tuned.wav \
        [--scale major --key c] [--engine granular] [--no-formant] \
        [--device cuda|cpu]
    python -m melonix_tpu_torch batch 'songs/*.wav' -o outdir \
        [--engine granular] [--markers m.json] [--autotune] [--lock] \
        [--device cuda|cpu]

The render of a WAV file through the granular engine (the default) or the
phase vocoder (``--formant`` to keep the spectral envelope, ``--lock`` for
identity phase locking), mono or ``--stereo``, the pitch curve of a WAV file
as JSON, its automatic pitch correction, and the batch render of many WAV
files (``render_batch``, which splits the jobs over the ranks of a
torch.distributed process group when the caller has one of world size
above 1).  The flags and defaults are
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


def cmd_render(args) -> int:
    from .engine.session import render_session
    from .io.audio import load_audio
    from .io.wav import write_wav
    from .markers import markers_from_json

    missing = _not_ported(args)
    if missing is not None:
        return _refuse(missing)
    wav, rate = load_audio(args.input, mono=not args.stereo)
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
    from .io.audio import load_audio

    missing = _not_wav(args.input)
    if missing is not None:
        return _refuse(missing)
    wav, rate = load_audio(args.input)
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
    from .io.audio import load_audio
    from .io.wav import write_wav
    from .markers import markers_to_json

    missing = _not_wav(args.input)
    if missing is not None:
        return _refuse(missing)
    wav, rate = load_audio(args.input)
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


def cmd_batch(args) -> int:
    """Serving path: render a fleet of files in slices of the batch path."""
    import glob
    import os

    from .engine.autotune import suggest_markers
    from .engine.batch import render_batch
    from .io.audio import load_audio
    from .io.wav import write_wav
    from .markers import markers_from_json, sort_markers
    from .parallel.sharded import world_size

    if args.format != "wav":
        return _refuse(f"--format {args.format}: only WAV output is ported "
                       "(ROADMAP queue A, item 14)")
    files = sorted({f for pat in args.inputs for f in glob.glob(pat)})
    if not files:
        print(f"batch: no files match {args.inputs}", file=sys.stderr)
        return 2
    for f in files:
        missing = _not_wav(f)
        if missing is not None:
            return _refuse(missing)
    os.makedirs(args.outdir, exist_ok=True)
    shared = []
    if args.markers:
        with open(args.markers) as fh:
            shared = markers_from_json(fh.read())

    t0 = time.perf_counter()
    by_rate: dict[int, list] = {}
    for f in files:
        wav, rate = load_audio(f)
        by_rate.setdefault(rate, []).append((f, wav))
    slice_n = max(4 * world_size(), 8)
    written, used_names = [], set()
    for rate, group in sorted(by_rate.items()):
        for g0 in range(0, len(group), slice_n):
            chunk = group[g0 : g0 + slice_n]
            tracks = [w for _f, w in chunk]
            if args.autotune:  # suggestions layer on top of the shared edit
                markers_l = [sort_markers(shared + suggest_markers(
                    w, rate, scale=args.scale, key=args.key,
                    strength=args.strength, vibrato=args.vibrato,
                    device=args.device)) for w in tracks]
            else:
                markers_l = [shared] * len(tracks)
            outs = render_batch(
                tracks, markers_l, rate, engine=args.engine,
                preserve_formants=args.engine == "pv" and not args.no_formant,
                phase_locking=args.engine == "pv" and args.lock,
                device=args.device,
            )
            for (f, _w), out in zip(chunk, outs):
                stem = os.path.splitext(os.path.basename(f))[0]
                name, k = f"{stem}.wav", 2
                while name in used_names:  # the same stem from another dir
                    name = f"{stem}-{k}.wav"
                    k += 1
                used_names.add(name)
                outp = os.path.join(args.outdir, name)
                write_wav(outp, out, rate)
                written.append(outp)
    dt = time.perf_counter() - t0
    print(f"batch: {len(written)} files ({len(by_rate)} rate group(s), "
          f"engine {args.engine} on {args.device}) in {dt:.2f}s -> "
          f"{args.outdir}")
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

    b = sub.add_parser("batch", help="render many WAV files")
    b.add_argument("inputs", nargs="+", help="file globs")
    b.add_argument("-o", "--outdir", required=True)
    b.add_argument("--engine", choices=["granular", "pv"], default="pv")
    b.add_argument("--markers", help="shared markers JSON applied to every file")
    b.add_argument("--autotune", action="store_true",
                   help="derive per-file markers from pitch correction")
    b.add_argument("--scale", choices=["chromatic", "major", "minor"],
                   default="chromatic")
    b.add_argument("--key", default="a")
    b.add_argument("--strength", type=float, default=1.0)
    b.add_argument("--vibrato", type=float, default=0.0)
    b.add_argument("--no-formant", action="store_true")
    b.add_argument("--lock", action="store_true",
                   help="identity phase locking (pv jobs)")
    b.add_argument("--format", default="wav",
                   help="output format (only wav is ported)")
    _device_flag(b)
    b.set_defaults(fn=cmd_batch)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

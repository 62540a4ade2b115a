"""Command-line interface of the PyTorch/CUDA port.

    python -m melonix_tpu_torch render in.wav --markers m.json -o out.wav \
        [--engine pv] [--stereo] [--device cuda|cpu]

The render of a WAV file through the granular engine (the default, mono or
``--stereo``) or the phase vocoder (mono).  The flags and defaults are those
of ``melonix_tpu``'s ``render`` subcommand, plus ``--device`` (default
``cuda``; there is no fallback to another device).  Flags whose code is not
ported yet exit with status 2 and name the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import sys
import time

# flag -> ROADMAP queue A item that ports it
NOT_PORTED = {
    "stereo": "item 8 (stereo / multichannel phase vocoder)",
    "formant": "item 6 (formant preservation)",
    "lock": "item 7 (identity phase locking)",
    "rate": "item 9 (CLI render options: --rate)",
    "trace": "item 9 (CLI render options: --trace)",
}


def _not_ported(args) -> str | None:
    if args.stereo and args.engine == "pv":
        return "--stereo with --engine pv: " + NOT_PORTED["stereo"]
    for flag in ("formant", "lock", "rate", "trace"):
        if getattr(args, flag):
            return f"--{flag}: " + NOT_PORTED[flag]
    if not args.input.lower().endswith(".wav"):
        return f"{args.input}: only WAV input is ported (ROADMAP queue A, item 14)"
    return None


def cmd_render(args) -> int:
    from .engine.session import render_session
    from .io.audio import downmix_mono
    from .io.wav import read_wav, write_wav
    from .markers import markers_from_json

    missing = _not_ported(args)
    if missing is not None:
        print(f"not ported yet: {missing} in ROADMAP.md queue A",
              file=sys.stderr)
        return 2
    wav, rate = read_wav(args.input)
    if not args.stereo:
        wav = downmix_mono(wav)
    markers = []
    if args.markers:
        with open(args.markers) as f:
            markers = markers_from_json(f.read())
    t0 = time.perf_counter()
    out = render_session(wav, markers, rate, engine=args.engine,
                         device=args.device)
    dt = time.perf_counter() - t0
    write_wav(args.output, out, rate, dtype=args.dtype)
    ch = out.shape[1] if out.ndim == 2 else 1
    detail = "phase-vocoder" if args.engine == "pv" else "granular"
    print(
        f"rendered {len(out)/rate:.2f}s x{ch}ch @{rate}Hz "
        f"({len(markers)} markers, {detail} on {args.device}) "
        f"in {dt:.2f}s -> {args.output}"
    )
    return 0


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
    r.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:N or cpu)")
    r.set_defaults(fn=cmd_render)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

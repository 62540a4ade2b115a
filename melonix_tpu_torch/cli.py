"""Command-line interface of the PyTorch/CUDA port.

    python -m melonix_tpu_torch render in.flac --markers m.json -o out.wav \
        [--engine pv [--formant] [--lock]] [--stereo] [--rate 48000] \
        [--trace DIR] [--device cuda|cpu]
    python -m melonix_tpu_torch pitch in.mp3 -o curve.json \
        [--method nsdf|hps|hybrid] [--device cuda|cpu]
    python -m melonix_tpu_torch autotune in.wav -o tuned.wav \
        [--scale major --key c] [--engine granular] [--no-formant] \
        [--device cuda|cpu]
    python -m melonix_tpu_torch batch 'songs/*.ogg' -o outdir \
        [--engine granular] [--markers m.json] [--autotune] [--lock] \
        [--format flac] [--device cuda|cpu]
    python -m melonix_tpu_torch info session.mlx
    python -m melonix_tpu_torch project in.mp3 --markers m.json -o s.mlx
    python -m melonix_tpu_torch spectrogram in.mlx -o scene.png \
        [--width 1280 --height 720] [--pyramid] [--device cuda|cpu]
    python -m melonix_tpu_torch ui [in.wav] [--port 8666] [--pyramid] \
        [--device cuda|cpu]

Every input is an audio file (WAV, FLAC, MP3 and Ogg Vorbis natively, the
long tail through the libav shim or the ``ffmpeg`` binary) or a project
(``.mlx``, or the reference's ``.melonix``), which brings its markers with
it.  ``render`` renders through the granular engine (the default) or the
phase vocoder (``--formant`` to keep the spectral envelope, ``--lock`` for
identity phase locking), mono or ``--stereo``, resampled to ``--rate`` and
profiled into ``--trace``; ``pitch`` writes the pitch curve as JSON,
``autotune`` the automatic pitch correction, ``batch`` the render of many
files (``render_batch``) in ``--format``; ``info`` prints a track's or
project's summary and ``project`` bundles audio and markers into a
``.mlx`` (or ``.melonix``) project; ``spectrogram`` renders the editor's
scene to a PNG (the reference-parity columns, or the |STFT| pyramid with
``--pyramid``) and ``ui`` serves the interactive browser editor.  The flags
and defaults are those of ``melonix_tpu``'s subcommands of the same names,
plus ``--device`` (default ``cuda``; there is no fallback to another
device).

Several cards, one process a card (the JAX package's mesh is one process
over every device): under a launcher (``parallel.launch``, or ``torchrun
--nproc_per_node=N -m melonix_tpu_torch batch|render ...``) ``batch`` and
``render`` join the process group on their rank's card (NCCL on the cards,
gloo for ``--device cpu``); ``batch`` splits each slice of ``max(4 *
ranks, 8)`` files over the ranks and a stereo ``render`` its channels.
Rank 0 alone writes files and prints the summary; a rank's failure is the
command's failure.  Started alone, every command stays in this process on
one card: a launched ``batch`` finished later than one process at every
fleet size measured (``batch_fleet.py``), since each rank first pays its
own start and rank 0 still decodes and writes every file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np


def _load_any(path: str):
    """(wav, rate, markers, brightness, tempo) from audio, .mlx, or a
    reference-format .melonix project (app.cpp:130-138 extension
    dispatch)."""
    from .config import DEFAULT_CONFIG as C
    from .io.audio import load_audio
    from .io.project import load_project

    if path.endswith(".mlx"):
        p = load_project(path)
        return p.wav, p.sample_rate, p.markers, p.brightness, p.tempo
    if path.endswith(".melonix"):
        from .io.melonix import load_melonix

        p = load_melonix(path)
        return p.wav, p.sample_rate, p.markers, p.brightness, p.tempo
    wav, rate = load_audio(path)
    return wav, rate, [], C.brightness, C.tempo


def _markers_from_arg(path: str | None, existing):
    from .markers import markers_from_json

    if path is None:
        return existing
    with open(path) as f:
        return markers_from_json(f.read())


@contextlib.contextmanager
def _rank(device: str):
    """The device a command computes on: under a launcher's environment or
    an existing process group, this rank's card after joining the group
    (``parallel.join_group``; left again at the end if it formed it), else
    ``device`` as given.  Yields (device, whether this process writes)."""
    from .parallel.launch import (grouped, is_rank0, join_group, launched,
                                  leave_group)

    if not (launched() or grouped()):
        yield device, True
        return
    try:
        dev = join_group(device)
        yield dev, is_rank0()
    finally:
        leave_group()


def cmd_render(args) -> int:
    with _rank(args.device) as (device, writer):
        return _render(args, device, writer)


def _render(args, device, writer: bool) -> int:
    from .engine.session import render_session
    from .io.audio import load_audio
    from .io.resample import resample
    from .io.wav import write_wav
    from .utils import trace

    if args.stereo and not args.input.endswith((".mlx", ".melonix")):
        wav, rate = load_audio(args.input, mono=False)
        markers = []
    else:
        if args.stereo:
            # Both project formats store mono audio (app.hpp:71-76).
            print("warning: projects store mono audio; --stereo ignored",
                  file=sys.stderr)
        wav, rate, markers, _b, _t = _load_any(args.input)
    markers = _markers_from_arg(args.markers, markers)
    t0 = time.perf_counter()
    ctx = (trace(args.trace) if args.trace and writer
           else contextlib.nullcontext())
    with ctx:
        out = render_session(wav, markers, rate, engine=args.engine,
                             preserve_formants=args.formant,
                             phase_locking=args.lock, device=device)
        out_rate = rate
        if args.rate and args.rate != rate:
            out = resample(out, rate, args.rate, device=device)
            out_rate = args.rate
    dt = time.perf_counter() - t0
    if not writer:
        return 0
    write_wav(args.output, out, out_rate, dtype=args.dtype)
    ch = out.shape[1] if out.ndim == 2 else 1
    detail = ("phase-vocoder"
              + (" formant-preserving" if args.formant else "")
              + (" phase-locked" if args.lock else "")
              if args.engine == "pv" else "granular")
    print(
        f"rendered {len(out)/out_rate:.2f}s x{ch}ch @{out_rate}Hz "
        f"({len(markers)} markers, {detail} on {device}) "
        f"in {dt:.2f}s -> {args.output}"
    )
    return 0


def cmd_spectrogram(args) -> int:
    from .config import Config
    from .markers import sort_markers
    from .ui.png import write_png
    from .ui.state import EditorState, Viewport
    from .ui.view import render_scene

    cfg = Config(tile_source="pyramid") if args.pyramid else Config()
    ed = EditorState(config=cfg, viewport=Viewport(args.width, args.height),
                     device=args.device, warm_up=False)
    ed.open_file(args.input)
    ed.markers = sort_markers(_markers_from_arg(args.markers, ed.markers))
    ed.invalidate()
    if args.start is not None:
        ed.start_time = args.start
    if args.range is not None:
        ed.range_time = args.range
    else:
        ed.range_time = max(len(ed.wav) / ed.sample_rate, 0.001)
    if args.note_start is not None:
        ed.start_note = args.note_start
    if args.note_range is not None:
        ed.range_note = args.note_range
    ed.set_brightness(args.brightness)
    t0 = time.perf_counter()
    img = render_scene(ed, synchronous_tiles=True)
    dt = time.perf_counter() - t0
    write_png(args.output, img)
    if ed._tile_server:
        ed._tile_server.close()
    print(f"scene {img.shape[1]}x{img.shape[0]} rendered on {args.device} "
          f"in {dt:.2f}s -> {args.output}")
    return 0


def cmd_ui(args) -> int:
    from .config import Config
    from .ui.web import serve

    cfg = Config(tile_source="pyramid") if args.pyramid else Config()
    serve(args.input, host=args.host, port=args.port, config=cfg,
          device=args.device)
    return 0


def cmd_pitch(args) -> int:
    from .engine.pitch import pitch_curve

    wav, rate, _m, _b, _t = _load_any(args.input)
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

    wav, rate, _m, _b, _t = _load_any(args.input)
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
    """Serving path: render a fleet of files in slices of the batch path,
    each slice over the ranks of the process group when there is one."""
    with _rank(args.device) as (device, writer):
        return _batch(args, device, writer)


def _batch(args, device, writer: bool) -> int:
    import glob
    import os

    from .engine.autotune import suggest_markers
    from .engine.batch import render_batch
    from .io.audio import write_audio
    from .markers import sort_markers
    from .parallel.sharded import world_size

    files = sorted({f for pat in args.inputs for f in glob.glob(pat)})
    if not files:
        print(f"batch: no files match {args.inputs}", file=sys.stderr)
        return 2
    if writer:
        os.makedirs(args.outdir, exist_ok=True)
    shared = _markers_from_arg(args.markers, [])

    t0 = time.perf_counter()
    by_rate: dict[int, list] = {}
    for f in files:
        # Audio files render with the shared/derived markers; project
        # files (.mlx/.melonix) carry their own edit with them.
        wav, rate, own, _b, _t = _load_any(f)
        by_rate.setdefault(rate, []).append((f, wav, own))
    slice_n = max(4 * world_size(), 8)
    written, used_names = [], set()
    for rate, group in sorted(by_rate.items()):
        for g0 in range(0, len(group), slice_n):
            chunk = group[g0 : g0 + slice_n]
            tracks = [w for _f, w, _m in chunk]
            base_l = [own if own else shared for _f, _w, own in chunk]
            if args.autotune:
                # Suggestions layer on top of the base edit: projects keep
                # their own markers, --markers keeps the shared set.
                markers_l = [sort_markers(base + suggest_markers(
                    w, rate, scale=args.scale, key=args.key,
                    strength=args.strength, vibrato=args.vibrato,
                    device=device)) for w, base in zip(tracks, base_l)]
            else:
                markers_l = base_l
            outs = render_batch(
                tracks, markers_l, rate, engine=args.engine,
                preserve_formants=args.engine == "pv" and not args.no_formant,
                phase_locking=args.engine == "pv" and args.lock,
                device=device,
            )
            if not writer:
                continue
            for (f, _w, _m), out in zip(chunk, outs):
                stem = os.path.splitext(os.path.basename(f))[0]
                name, k = f"{stem}.{args.format}", 2
                while name in used_names:  # the same stem from another dir
                    name = f"{stem}-{k}.{args.format}"
                    k += 1
                used_names.add(name)
                outp = os.path.join(args.outdir, name)
                write_audio(outp, out, rate)
                written.append(outp)
    dt = time.perf_counter() - t0
    if writer:
        print(f"batch: {len(written)} files ({len(by_rate)} rate group(s), "
              f"engine {args.engine} on {device}, {world_size()} rank(s)) "
              f"in {dt:.2f}s -> {args.outdir}")
    return 0


def cmd_info(args) -> int:
    from .engine.grains import build_grain_table
    from .engine.maps import MapKnots

    wav, rate, markers, brightness, tempo = _load_any(args.input)
    table = build_grain_table(wav)
    knots = MapKnots.from_markers(markers, rate, len(wav))
    print(json.dumps({
        "samples": len(wav),
        "sample_rate": rate,
        "duration_sec": round(len(wav) / rate, 3),
        "warped_duration_sec": round(knots.duration(), 3),
        "grains": len(table),
        "markers": len(markers),
        "brightness": brightness,
        "tempo": tempo,
        "peak": round(float(np.abs(wav).max()) if len(wav) else 0.0, 4),
    }, indent=2))
    return 0


def cmd_project(args) -> int:
    from .io.project import Project, save_project

    wav, rate, markers, brightness, tempo = _load_any(args.input)
    markers = _markers_from_arg(args.markers, markers)
    proj = Project(wav=wav, sample_rate=rate, markers=markers,
                   brightness=brightness, tempo=tempo)
    if args.output.endswith(".melonix"):  # reference-format interop
        from .io.melonix import save_melonix

        out = save_melonix(args.output, proj)
    else:
        out = save_project(args.output, proj)
    print(f"saved project ({len(markers)} markers) -> {out}")
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
    r.add_argument("--trace",
                   help="write a torch.profiler trace to this directory")
    r.add_argument("--stereo", action="store_true", help="keep source channels")
    r.add_argument("--formant", action="store_true",
                   help="preserve the spectral envelope (pv engine only)")
    r.add_argument("--lock", action="store_true",
                   help="identity phase locking (pv engine only)")
    r.add_argument("--rate", type=int, help="resample the output to this rate")
    _device_flag(r)
    r.set_defaults(fn=cmd_render)

    s = sub.add_parser("spectrogram", help="render the editor scene to PNG")
    s.add_argument("input")
    s.add_argument("--markers")
    s.add_argument("-o", "--output", required=True)
    s.add_argument("--width", type=int, default=1280)
    s.add_argument("--height", type=int, default=720)
    s.add_argument("--start", type=float)
    s.add_argument("--range", type=float, dest="range")
    s.add_argument("--note-start", type=float)
    s.add_argument("--note-range", type=float)
    s.add_argument("--brightness", type=float, default=50.0)
    s.add_argument("--pyramid", action="store_true",
                   help="device-resident multi-res STFT pyramid instead of "
                        "reference-parity on-demand columns")
    _device_flag(s)
    s.set_defaults(fn=cmd_spectrogram)

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

    b = sub.add_parser("batch", help="render many files")
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
                   help="output extension for write_audio (wav/flac/m4a/...)")
    _device_flag(b)
    b.set_defaults(fn=cmd_batch)

    i = sub.add_parser("info", help="track / project summary")
    i.add_argument("input")
    i.set_defaults(fn=cmd_info)

    j = sub.add_parser("project",
                       help="bundle audio + markers into a .mlx project")
    j.add_argument("input")
    j.add_argument("--markers")
    j.add_argument("-o", "--output", required=True)
    j.set_defaults(fn=cmd_project)

    u = sub.add_parser("ui", help="interactive browser editor")
    u.add_argument("input", nargs="?", help="audio file or .mlx project to open")
    u.add_argument("--host", default="127.0.0.1")
    u.add_argument("--port", type=int, default=8666)
    u.add_argument("--pyramid", action="store_true",
                   help="device-resident multi-res tile pyramid (fast pan/zoom)")
    _device_flag(u)
    u.set_defaults(fn=cmd_ui)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

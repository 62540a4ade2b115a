"""Seeded inputs: the takes and the marker edits the cells send.

The audio generators are frozen copies of ``chip_smoke.py``'s
``make_song`` (two vibrato partials and noise, the JAX bench's song) and
``make_melody`` (detuned three-partial notes of 1.5 s), with what they
fixed drawn from the seed instead: the song's contour, the melody's notes
and detunes, and a second channel mixed from the same notes.  Every seed
gives the same sizes; only the values differ.  Samples are made on the
run's device in a few large calls (float64 phase, float32 samples); the
phase's running sum is taken on the host, in order, so that a seed gives
the same bits in every process.

The marker forms follow ``chip_smoke.py``'s ``bench_markers`` (the JAX
bench's 12-marker edit, bench.py:786-790) and autotune's one correction
a note.  Markers are plain tuples ``(sample, note, d_time, pitch_bend)``:
the request turns them into the program's own type.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of ``seed``'s inputs: any whole number
    (negative or past 64 bits too) and a tuple of tags give independent
    streams that repeat."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, device, *tags: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, *tags))
    return g


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *tags))


def running_phase(f: torch.Tensor, sr: int) -> torch.Tensor:
    """``2 pi cumsum(f) / sr`` in float64, summed in order on the host:
    the card's parallel scan may sum in another order from one process
    to the next, and the same seed must give the same bits."""
    ph = np.cumsum(f.cpu().numpy())
    ph *= 2 * math.pi / sr
    return torch.from_numpy(ph).to(f.device)


def rest_gains(sr: int, n: int, seed: int, take: int, device, *,
               every_s: float, length_s: tuple[float, float], fade_s: float,
               floor_db: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(partials' gain, noise's gain), (n,) float64 on ``device``: one rest
    in each slot of about ``every_s`` seconds (at least one slot), at a
    drawn place, of a drawn length in ``length_s`` seconds.  A rest fades out and in again linearly in
    dB, over ``fade_s`` each way, down to ``floor_db``.  Rests alternate,
    from a drawn first kind, between a breath (the partials fade, the
    noise stays: the clarity falls) and a silence (both fade: the energy
    falls while the clarity stays)."""
    dev = torch.device(device)
    count = max(1, round(n / (every_s * sr)))
    r = rng(seed, 4, take)
    lengths = r.uniform(length_s[0], length_s[1], count)
    places = r.uniform(0.0, 1.0, count)
    first = int(r.integers(0, 2))
    db_p = torch.zeros(n, dtype=torch.float64, device=dev)
    db_n = torch.zeros(n, dtype=torch.float64, device=dev)
    slot = n / count
    for k in range(count):
        m = min(int(lengths[k] * sr), int(slot))
        a = int(k * slot + places[k] * (slot - m))
        tau = torch.arange(m, dtype=torch.float64, device=dev) / sr
        depth = torch.minimum(tau, m / sr - tau).div_(fade_s).clamp_(max=1.0)
        db_p[a:a + m] = floor_db * depth
        if (k + first) % 2:
            db_n[a:a + m] = floor_db * depth
    return torch.pow(10.0, db_p / 20.0), torch.pow(10.0, db_n / 20.0)


def song(sr: int, seconds: float, seed: int, device, take: int = 0,
         rests: dict | None = None) -> torch.Tensor:
    """(n,) float32 on ``device``: ``make_song``'s two partials (0.5 and
    0.2) of a vibrato contour and noise 34 dB below, the contour seeded:
    a centre 3 semitones either side of 220 Hz, a vibrato of 0.2-0.3 Hz
    and 0.4-0.6 semitones from a seeded phase.  ``rests`` (the keywords
    of :func:`rest_gains`) adds rests, as a sung take has them."""
    dev = torch.device(device)
    g = generator(seed, dev, 1, take)
    u = torch.rand(4, generator=g, dtype=torch.float64, device=dev).tolist()
    centre = 220.0 * 2.0 ** ((6.0 * u[0] - 3.0) / 12.0)
    rate, depth, ph = 0.2 + 0.1 * u[1], 0.4 + 0.2 * u[2], 2 * math.pi * u[3]
    n = int(sr * seconds)
    t = torch.arange(n, dtype=torch.float64, device=dev) / sr
    f = centre * torch.exp2(torch.sin(2 * math.pi * rate * t + ph) * depth)
    phase = running_phase(f, sr)
    x = 0.5 * torch.sin(phase) + 0.2 * torch.sin(2.0 * phase)
    noise = 0.01 * torch.randn(n, generator=g, dtype=torch.float64,
                               device=dev)
    if rests:
        g_p, g_n = rest_gains(sr, n, seed, take, dev, **rests)
        x *= g_p
        noise *= g_n
    x += noise
    return x.to(torch.float32)


def melody_notes(sr: int, seconds: float, seed: int, take: int = 0):
    """``make_melody``'s notes: (notes int64, cents float64), one a 1.5 s
    note, steps of 2-5 semitones within notes 43-62, each detuned by
    20-45 cents either way."""
    r = rng(seed, 2, take)
    n_notes = int(seconds / 1.5)
    notes = np.empty(n_notes, np.int64)
    notes[0] = 52
    for i in range(1, n_notes):
        step = int(r.choice([-5, -4, -3, -2, 2, 3, 4, 5]))
        nxt = notes[i - 1] + step
        notes[i] = nxt if 43 <= nxt <= 62 else notes[i - 1] - step
    cents = r.uniform(20.0, 45.0, n_notes) * r.choice([-1.0, 1.0], n_notes)
    return notes, cents


# The two channels' partial mixes: the left is make_melody's; the right
# (an assumed mix, named in the configuration) weights the same partials
# otherwise, from seeded phase offsets.
LEFT_MIX = (0.5, 0.25, 0.12)
RIGHT_MIX = (0.35, 0.3, 0.18)


def melody(sr: int, seconds: float, seed: int, device, channels: int,
           take: int = 0) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """((n, channels) float32 on ``device``, notes, cents): the detuned
    melody, noise 40 dB below the fundamental on each channel; the second
    channel mixes the same notes as :data:`RIGHT_MIX` says."""
    dev = torch.device(device)
    notes, cents = melody_notes(sr, seconds, seed, take)
    hz = 55.0 * 2.0 ** ((notes - 24 + cents / 100.0) / 12.0)
    per = int(1.5 * sr)
    f = torch.from_numpy(hz).to(dev).repeat_interleave(per)
    phase = running_phase(f, sr)
    g = generator(seed, dev, 3, take)
    offs = [2 * math.pi * u for u in torch.rand(
        3, generator=g, dtype=torch.float64, device=dev).tolist()]
    cols = []
    for c in range(channels):
        mix, off = (LEFT_MIX, (0.0, 0.0, 0.0)) if c == 0 else (RIGHT_MIX,
                                                             offs)
        x = sum(a * torch.sin((h + 1) * phase + off[h])
                for h, a in enumerate(mix))
        x += 0.005 * torch.randn(f.shape[0], generator=g,
                                 dtype=torch.float64, device=dev)
        cols.append(x.to(torch.float32))
    return torch.stack(cols, dim=1), notes, cents


def edit_markers(r: np.random.Generator, n: int, count: int,
                 jitter: float, d_time: tuple[float, float],
                 bend: tuple[float, float], note: float = 57.0) -> list:
    """``bench_markers``' form with its numbers drawn: marker i near
    (i + 1) n / (count + 2), moved by up to ``jitter`` of that spacing;
    ``d_time`` of a drawn size, sign alternating; a bend of a drawn size in
    semitones, sign alternating as ``(-1) ** i``."""
    gap = n / (count + 2)
    out = []
    for i in range(count):
        pos = int((i + 1) * gap + r.uniform(-jitter, jitter) * gap)
        dt = r.uniform(*d_time) * (1.0 if i % 2 == 0 else -1.0)
        b = r.uniform(*bend) * (-1.0) ** i
        out.append((pos, note, float(dt), float(b)))
    return out


def snap_markers(r: np.random.Generator, sr: int, notes: np.ndarray,
                 cents: np.ndarray, jitter_s: float, extra_share: float,
                 extra: tuple[float, float]) -> list:
    """Autotune's correction as one marker a note: at the note's middle,
    moved by up to ``jitter_s`` seconds, with the bend that snaps its
    detune (``-cents / 100``); a drawn ``extra_share`` of the notes add a
    bend of ``extra`` semitones, either way."""
    per = int(1.5 * sr)
    out = []
    for i, (nt, c) in enumerate(zip(notes, cents)):
        pos = int(i * per + per // 2 + r.uniform(-jitter_s, jitter_s) * sr)
        b = -float(c) / 100.0
        if r.uniform() < extra_share:
            b += r.uniform(*extra) * r.choice([-1.0, 1.0])
        out.append((pos, float(nt), 0.0, float(b)))
    return out

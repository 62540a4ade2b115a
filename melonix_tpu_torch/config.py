"""Framework configuration.

All tunables of the reference application are compile-time constants scattered
through its sources (spec.cpp:8, app.cpp:19, range.hpp:4, app.cpp:243,
app.cpp:169, app.cpp:204).  Here they live in one frozen dataclass so every
engine component shares a single source of truth and tests can build variant
configs.  A copy of ``melonix_tpu/config.py``: the two packages share no code.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # --- Spectrogram engine (reference: spec.cpp) ---
    # 32768-point end-anchored DFT per spectrogram column (spec.cpp:8,
    # ``SpectrSize = 8 * 4096``).  Magnitudes of the first ``spectr_size // 2``
    # bins are kept, normalized by ``spectr_size`` (spec.cpp:62-64).
    spectr_size: int = 8 * 4096
    # Exponential pre-window decay rate applied to samples before the column's
    # start sample: ``exp(-2.5e-4 * (start - i))`` (spec.cpp:58).
    spec_decay: float = 2.5e-4
    # LRU capacity of spectrum / texture caches (range.hpp:4, ``MaxRanges``).
    max_ranges: int = 4000
    # Spectrogram tiles are log-frequency texel strips (runtime/tiles.py):
    # ``tile_texels`` log-spaced texels over [tile_frac_min, 1] x Nyquist.
    # 2048 texels over ~12 octaves is >= 14 texels/semitone everywhere.
    tile_texels: int = 2048
    tile_frac_min: float = 2.5e-4
    # Tile source: "reference" = on-demand end-anchored 32768-pt columns
    # (exact spec.cpp parity); "pyramid" = HBM-resident multi-resolution
    # Hann-STFT pyramid, zoom/pan becomes a pure gather (spec_pyramid.py).
    tile_source: str = "reference"

    # --- Modern STFT mode (new capability; BASELINE.json configs) ---
    stft_size: int = 2048
    stft_hop: int = 512  # 75% overlap

    # --- Granular engine (reference: app.cpp) ---
    # Preferred grain length in samples (app.cpp:19).
    preferred_grain_size: int = 1500
    # Zero-crossing look-around for the primary grain search (app.cpp:169)
    # and the fallback linear scan (app.cpp:204).
    zc_look_around: int = 7
    zc_look_around_fallback: int = 3

    # --- Playback (reference: app.cpp:238-249) ---
    audio_buffer: int = 1024

    # --- UI defaults (reference: app.hpp:43-64) ---
    start_time: float = 0.0
    range_time: float = 10.0
    start_note: float = 24.0
    range_note: float = 60.0
    brightness: float = 50.0
    tempo: float = 130.0

    # --- Pitch detection (new capability; BASELINE.json configs) ---
    pitch_frame: int = 2048
    pitch_hop: int = 512
    pitch_fmin: float = 55.0
    pitch_fmax: float = 1760.0

    @property
    def spec_bins(self) -> int:
        return self.spectr_size // 2

    def brightness_to_k(self, brightness: float | None = None) -> float:
        """Spectrogram gain from the brightness slider.

        Reference: ``k = powf(2, brightness / 10 + 9)`` (app.cpp:75); the
        default brightness of 50 gives k = 2**14 = 16384.
        """
        b = self.brightness if brightness is None else brightness
        return float(2.0 ** (b / 10.0 + 9.0))


DEFAULT_CONFIG = Config()

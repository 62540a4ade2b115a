"""Editor state machine — the App-controller equivalent (headless).

Mirrors the reference's UI semantics (app.cpp) without any GL/SDL coupling:
the same state fields (app.hpp:34-68), the same interaction rules
(pan/zoom/marker editing, app.cpp:743-838, 887-980), the same follow-mode
auto-scroll (app.cpp:108-127, implementing the *intended* smoothing — the
reference's ``< 0.001`` gate looks inverted per SURVEY.md), and the same
derived-state invalidation contract (invalidateCache, app.cpp:840-852).

Any front end (the bundled raster renderer in ui/view.py, a future SDL/GL
shell, or tests) drives this object with events and reads its fields.

Counterpart of ``melonix_tpu/ui/state.py``: the gestures, the history,
follow mode and the invalidation contract are the same host code.  Every
device user the state builds or calls (the waveform pyramid, the |STFT|
pyramid, the player, the tile server, the export renders and the pitch
overlay) runs on ``device`` (default ``"cuda"``; ``"cpu"`` runs the
kernels' plain twins; no run falls back to another device).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, Config
from ..engine.grains import GrainTable, build_grain_table
from ..engine.maps import MapKnots
from ..engine.pyramid import Pyramid, build_pyramid
from ..engine.spectral import require_device
from ..io.audio import load_audio
from ..io.project import Project, load_project, save_project
from ..markers import Marker, sort_markers

# Mouse buttons / modifiers (SDL-compatible numbering)
BUTTON_LEFT, BUTTON_MIDDLE, BUTTON_RIGHT = 1, 2, 3
MOD_CTRL, MOD_ALT = 1, 2

MENU_BAR_PX = 20  # reference: y -= 20 (app.cpp:748)


@dataclasses.dataclass
class Viewport:
    width: int = 1280
    height: int = 720

    @property
    def lane_height(self) -> float:
        """Spectrogram lane height: display * 0.9 - menu (app.cpp:752)."""
        return self.height * 0.9 - MENU_BAR_PX


class EditorState:
    def __init__(self, config: Config = DEFAULT_CONFIG, viewport: Viewport | None = None,
                 device=None, warm_up: bool = True):
        self.config = config
        self.viewport = viewport or Viewport()
        # Checked when a file is loaded (require_device), so a server can be
        # built before it knows whether the card is there.
        self.device = torch.device("cuda" if device is None else device)
        # Off a CPU, every open warms the session's paths on a thread
        # (runtime/warmup.py); ``warmup`` is the last open's thread.  A
        # one-shot scene (the CLI's ``spectrogram``) passes False.
        self.warm_up = warm_up
        self.warmup = None

        self.wav: np.ndarray = np.zeros(0, np.float32)
        self.sample_rate: int = 0
        self.markers: list[Marker] = []
        self.selected: Optional[int] = None  # index into markers
        # Edit history (added capability — the reference has no undo).
        # Each entry is a full marker snapshot: edits are tiny host-side
        # structures (SURVEY §7), so snapshots beat command objects.
        self._undo: list[list[Marker]] = []
        self._redo: list[list[Marker]] = []
        self._history_nav = False  # True inside undo/redo application
        self.open_count = 0  # bumped by every (re)load — see _preproc

        # View state (app.hpp:43-46 defaults)
        self.start_time = config.start_time
        self.range_time = config.range_time
        self.start_note = config.start_note
        self.range_note = config.range_note
        self.cursor_sec = 0.0
        self.is_playing = False
        self.follow_mode = False
        self.brightness = config.brightness
        self.tempo = config.tempo
        self.save_name = ""
        self.source_path = ""  # what was opened (autosave identity)
        self.engine = "granular"  # live render engine: "granular" | "pv"
        self.formant = False  # PV formant preservation (pv engine only)
        self.phase_locking = False  # PV identity phase locking (pv only)
        self.show_pitch = False  # detected-pitch overlay in the scene
        self.pitch = None  # cached engine.pitch.PitchCurve (per import)
        self._pitch_thread = None  # background NSDF analysis (CUDA only)
        self._pitch_wav = None  # samples the running analysis is for

        # Derived state (rebuilt by _preproc / invalidated on edits)
        self.grains: GrainTable | None = None
        self.pyramid: Pyramid | None = None
        self.spec_pyramid = None  # SpecPyramid when config.tile_source == "pyramid"
        self.knots: MapKnots | None = None
        self.player = None  # engine.player.Player — the live playback engine
        self._tile_server = None
        self._dirty_listeners = []

    # ------------------------------------------------------------------
    # Derived state management
    # ------------------------------------------------------------------

    @property
    def loaded(self) -> bool:
        return self.sample_rate > 0 and len(self.wav) > 0

    def _rebuild_knots(self) -> None:
        if self.loaded:
            self.knots = MapKnots.from_markers(self.markers, self.sample_rate, len(self.wav))

    def invalidate(self) -> None:
        """Edit happened: rebuild maps, clear view caches (app.cpp:840-852).

        The live player gets the new knots and drops its planned-ahead
        backlog, so the next audio buffer reflects the edit — the
        reference's marker-edit-under-audio-lock contract
        (app.cpp:935-941)."""
        self._rebuild_knots()
        if self.player is not None and self.knots is not None:
            self.player.set_knots(self.knots)
        if self._tile_server is not None:
            self._tile_server.clear()
        # A real edit orphans the redo branch.  Cleared here — not in
        # push_history — so a select-only click (which pushes a history
        # entry but never invalidates) cannot destroy a pending redo.
        if not self._history_nav:
            self._redo.clear()
        for fn in self._dirty_listeners:
            fn()

    def on_invalidate(self, fn) -> None:
        self._dirty_listeners.append(fn)

    # ------------------------------------------------------------------
    # Edit history (undo/redo — added capability, no reference analogue)
    # ------------------------------------------------------------------

    _HISTORY_CAP = 200

    def _marker_snapshot(self) -> list[Marker]:
        return [Marker(m.sample, m.note, m.d_time, m.pitch_bend)
                for m in self.markers]

    def push_history(self) -> None:
        """Record the marker state BEFORE a discrete edit gesture (add,
        delete, drag start, numeric edit, autotune).  Select-only clicks
        push too and are deduped here; the redo branch is cleared by the
        edit itself (invalidate), never by a no-op selection."""
        snap = self._marker_snapshot()
        if self._undo and self._undo[-1] == snap:
            return
        self._push_undo(snap)

    def _push_undo(self, snap: list[Marker]) -> None:
        """Capped append — redo() re-appends through here too, else
        interleaved undo/redo cycles ratchet the stack past the cap."""
        self._undo.append(snap)
        if len(self._undo) > self._HISTORY_CAP:
            del self._undo[0]

    def undo(self) -> bool:
        """Restore the state before the last edit gesture.  Returns
        whether anything changed."""
        cur = self._marker_snapshot()
        while self._undo:
            snap = self._undo.pop()
            if snap != cur:  # skip select-only no-op entries
                self._redo.append(cur)
                self._apply_history(snap)
                return True
        return False

    def redo(self) -> bool:
        cur = self._marker_snapshot()
        while self._redo:
            snap = self._redo.pop()
            if snap != cur:
                self._push_undo(cur)
                self._apply_history(snap)
                return True
        return False

    def _apply_history(self, snap: list[Marker]) -> None:
        self.markers = snap
        self.selected = None
        self._history_nav = True
        try:
            self.invalidate()
        finally:
            self._history_nav = False

    def _preproc(self) -> None:
        """Rebuild all derived state after (re)loading samples
        (App::preproc, app.cpp:153-252)."""
        self.open_count += 1  # lets listeners tell a (re)open from an edit
        self.selected = None
        self.grains = build_grain_table(self.wav, self.config)
        self.pyramid = build_pyramid(self.wav, device=self.device)
        if self.config.tile_source == "pyramid":
            from ..runtime.spec_pyramid import SpecPyramid

            self.spec_pyramid = SpecPyramid(self.wav, config=self.config,
                                            device=self.device)
        self._rebuild_knots()
        from ..engine.player import Player

        self.player = Player(
            self.wav, self.grains, self.knots, config=self.config,
            engine=self.engine, device=self.device,
        )
        self.player.set_formant(self.formant)
        self.player.set_phase_locking(self.phase_locking)
        self.invalidate()
        if self.device.type != "cpu":
            # First view first: the tile server (and its worker thread)
            # exists from the open on, so the first frame's burst goes
            # straight to the card, ahead of the warm-up below: a silent
            # track of this length through every path, so the first render,
            # live read and tile burst find their first-use costs paid (the
            # reference's plan at open, FFTW_MEASURE at spec.cpp:15).
            _ = self.tile_server
            if self.warm_up:
                from ..runtime import warmup

                self.warmup = warmup.warmup_session_async(
                    len(self.wav), self.sample_rate, device=self.device)
        # A new file with the overlay enabled recomputes its curve
        # (cleanup cleared self.pitch; the checkbox stays checked).
        self._ensure_pitch()

    def _cleanup(self) -> None:
        """Reset caches and view on file change (app.cpp:1156-1164)."""
        if self._tile_server is not None:
            self._tile_server.close()
            self._tile_server = None
        self.start_time = 0.0
        self.range_time = 10.0
        self.cursor_sec = 0.0
        self.is_playing = False
        self.pitch = None  # new samples -> recompute the pitch overlay
        self._undo.clear()
        self._redo.clear()

    @property
    def tile_server(self):
        """Lazy tile server bound to the current samples + brightness
        (App::getTex's lazy SpecCache, app.cpp:881-884)."""
        if self._tile_server is None and self.loaded:
            from ..runtime.tiles import TileServer

            compute = (
                self.spec_pyramid.compute_columns
                if self.spec_pyramid is not None
                else None
            )
            self._tile_server = TileServer(
                self.wav,
                k=self.config.brightness_to_k(self.brightness),
                config=self.config,
                compute=compute,
                device=self.device,
            )
        return self._tile_server

    # ------------------------------------------------------------------
    # File operations
    # ------------------------------------------------------------------

    def open_file(self, path: str) -> None:
        """Extension dispatch (app.cpp:130-138).  A device that is not
        there raises before anything is decoded: the loaded session stays
        as it was."""
        require_device(self.device)
        if self.warm_up and self.device.type == "cuda":
            from ..runtime import warmup

            # nvcc (kernels/_build.py) starts before the decode, beside the
            # native runtime's build, not after the open in the tile worker
            warmup.build_async()
        if path.endswith(".mlx"):
            self.load_project_file(path)
        elif path.endswith(".melonix"):
            self.load_melonix_file(path)
        else:
            self.import_file(path)

    def import_file(self, path: str) -> None:
        # Fail-soft: decode into temporaries FIRST — a bad file must leave
        # the loaded session untouched (the reference's decode error paths
        # return before mutating state, app.cpp:628-694).
        wav, rate = load_audio(path)
        self._cleanup()
        self.wav, self.sample_rate = wav, rate
        self.markers = []
        self.save_name = ""
        self.source_path = os.path.abspath(path)
        self._preproc()

    def load_project_file(self, path: str) -> None:
        p = load_project(path)  # may raise — prior session stays usable
        self._cleanup()
        self.wav, self.sample_rate = p.wav, p.sample_rate
        self.markers = p.markers
        self.brightness = p.brightness
        self.tempo = p.tempo
        self.save_name = os.path.abspath(path)
        self.source_path = os.path.abspath(path)
        self._preproc()

    def load_melonix_file(self, path: str) -> None:
        """Reference `.melonix` project interop (app.cpp:1124-1154)."""
        from ..io.melonix import load_melonix

        p = load_melonix(path)  # may raise — prior session stays usable
        self._cleanup()
        self.wav, self.sample_rate = p.wav, p.sample_rate
        self.markers = p.markers
        self.brightness = p.brightness
        self.tempo = p.tempo
        self.save_name = os.path.abspath(path)
        self.source_path = os.path.abspath(path)
        self._preproc()

    def save_project_file(self, path: str | None = None) -> str:
        path = path or self.save_name
        if not path:
            raise ValueError("no save name; use Save As")
        proj = Project(
            wav=self.wav,
            sample_rate=self.sample_rate,
            markers=self.markers,
            brightness=self.brightness,
            tempo=self.tempo,
        )
        if path.endswith(".melonix"):  # reference-format interop
            from ..io.melonix import save_melonix

            out = save_melonix(path, proj)
        else:
            out = save_project(path, proj)
        self.save_name = os.path.abspath(out)
        return out

    def export_wav(self, path: str, engine: str | None = None) -> None:
        """Offline render through the same engine as playback
        (App::exportWav, app.cpp:1194-1215).  ``engine`` defaults to the
        session's selected live engine, so what you hear is what exports."""
        self.is_playing = False
        engine = engine or self.engine
        if engine == "pv":
            from ..engine.phase_vocoder import render_track_pv

            out = render_track_pv(self.wav, self.knots, config=self.config,
                                  preserve_formants=self.formant,
                                  phase_locking=self.phase_locking,
                                  device=self.device)
        else:
            from ..engine.render import render_track

            out = render_track(self.wav, self.grains, self.knots, config=self.config,
                               device=self.device)
        # One dispatch site: write_audio encodes .wav via write_wav
        # (int16, the reference's export) and everything else natively
        # or through the libav shim — added capability (save-wav.cpp is
        # WAV-only).
        from ..io.audio import write_audio

        write_audio(path, np.asarray(out, np.float32), self.sample_rate)

    # ------------------------------------------------------------------
    # Time helpers
    # ------------------------------------------------------------------

    def duration(self) -> float:
        return self.knots.duration() if self.knots else 0.0

    def set_engine(self, engine: str) -> None:
        """Control-center engine toggle: granular (reference parity) or pv
        (quality).  Applies live — the player's next buffer comes from the
        newly selected engine (VERDICT round 2, next #2)."""
        if engine not in ("granular", "pv"):
            raise ValueError(f"unknown engine: {engine}")
        self.engine = engine
        if self.player is not None:
            self.player.set_engine(engine)

    def set_show_pitch(self, on: bool) -> None:
        """Detected-pitch overlay (added capability: the batched NSDF
        curve, engine/pitch.py) — computed once per import, on demand."""
        self.show_pitch = bool(on)
        self._ensure_pitch()

    def _ensure_pitch(self) -> None:
        """Compute the overlay curve when the overlay wants one.

        On the card the first analysis of a process may wait for the
        kernels' build (seconds), and this is reached from the HTTP
        ``/control`` handler under the server lock — blocking there would
        starve the live audio stream and the frame poll, so compute in a
        background thread and let the page poll pick the overlay up when
        it lands.  CPU (tests) computes synchronously for determinism.
        A failing analysis leaves the overlay absent (the reference's
        fail-soft); ``chip_smoke.py`` checks that the curve lands on the
        card."""
        if not (self.show_pitch and self.loaded) or self.pitch is not None:
            return
        wav, sr = self.wav, self.sample_rate

        def work() -> None:
            from ..engine.pitch import pitch_curve

            try:
                curve = pitch_curve(wav, sr, config=self.config,
                                    device=self.device)
            except Exception:
                return  # fail-soft: the overlay just stays absent
            if self.wav is wav:  # discard if the file changed meanwhile
                self.pitch = curve

        if self.device.type == "cpu":
            work()
            return
        if (self._pitch_thread is not None and self._pitch_thread.is_alive()
                and self._pitch_wav is wav):
            return  # an analysis for THESE samples is already running
        import threading

        self._pitch_wav = wav
        self._pitch_thread = threading.Thread(
            target=work, name="pitch-overlay", daemon=True
        )
        self._pitch_thread.start()

    def set_formant(self, on: bool) -> None:
        """Formant-preservation toggle for the PV engine (added
        capability; applies live and to export)."""
        self.formant = bool(on)
        if self.player is not None:
            self.player.set_formant(self.formant)

    def set_phase_locking(self, on: bool) -> None:
        """Identity-phase-locking toggle for the PV engine (BASELINE
        north star; applies live and to export)."""
        self.phase_locking = bool(on)
        if self.player is not None:
            self.player.set_phase_locking(self.phase_locking)

    def set_brightness(self, b: float) -> None:
        """Brightness slider → k = 2^(b/10 + 9); rebuilds tiles when it
        moves meaningfully (app.cpp:74-80)."""
        new_k = self.config.brightness_to_k(b)
        old_k = self.config.brightness_to_k(self.brightness)
        self.brightness = float(b)
        if abs(new_k - old_k) > 1e-3 and self._tile_server is not None:
            self._tile_server.set_brightness_k(new_k)

    # ------------------------------------------------------------------
    # Interactions (app.cpp:743-838, 887-1018)
    # ------------------------------------------------------------------

    def _time_limits(self) -> tuple[float, float]:
        """Pan/zoom clamps: ±half-view beyond the track (app.cpp:756-758)."""
        dur = len(self.wav) / self.sample_rate
        left = max(-self.range_time * 0.5, -0.5 * dur)
        right = min(dur + self.range_time * 0.5, 1.5 * dur)
        return left, right

    def mouse_motion(self, x: float, y: float, dx: float, dy: float, buttons: int, mods: int = 0) -> None:
        if not self.loaded:
            return
        y -= MENU_BAR_PX
        width = self.viewport.width
        height = self.viewport.lane_height

        if buttons & (1 << (BUTTON_MIDDLE - 1)):
            left_limit, right_limit = self._time_limits()
            if mods & MOD_CTRL:
                # Zoom time about cursor x (app.cpp:759-776)
                zoom = 1.0 + 0.01 * dy
                cursor_pos = x / width * self.range_time + self.start_time
                new_start = (self.start_time - cursor_pos) * zoom + cursor_pos
                new_end = (self.start_time + self.range_time - cursor_pos) * zoom + cursor_pos
                if left_limit <= new_start <= right_limit:
                    self.start_time = new_start
                if left_limit <= new_end <= right_limit:
                    self.range_time = new_end - self.start_time
                elif new_end < left_limit:
                    self.range_time = 10.0
                else:
                    self.range_time = right_limit - self.start_time
                self.follow_mode = False
            elif mods & MOD_ALT:
                # Note-axis pan (dy) + zoom (dx) (app.cpp:777-803)
                delta = dy * self.range_note / height
                new_start_note = self.start_note + delta
                if new_start_note < 0.0:
                    new_start_note = 0.0
                elif new_start_note + self.range_note > 127.0:
                    new_start_note = 127.0 - self.range_note
                self.start_note = new_start_note

                zoom = 1.0 - 0.001 * dx
                cursor_pos = (height - y) / height * self.range_note + self.start_note
                new_start = (self.start_note - cursor_pos) * zoom + cursor_pos
                new_end = (self.start_note + self.range_note - cursor_pos) * zoom + cursor_pos
                if 0.0 <= new_start <= 127.0:
                    self.start_note = new_start
                if 0.0 <= new_end <= 127.0:
                    self.range_note = new_end - self.start_note
                elif new_end < 0.0:
                    self.range_note = 10.0
                else:
                    self.range_note = 127.0 - self.start_note
            else:
                # Pan time (app.cpp:804-817)
                dt = dx * self.range_time / width
                new_start = self.start_time - dt
                new_start = max(new_start, left_limit)
                if new_start + self.range_time > right_limit:
                    new_start = right_limit - self.range_time
                self.start_time = new_start
                self.follow_mode = False
        elif buttons & (1 << (BUTTON_LEFT - 1)):
            if y > height:
                # Scrub in the waveform lane (app.cpp:819-828)
                self.seek(x * self.range_time / width + self.start_time)
            elif self.selected is not None:
                # Drag marker: dTime += dx, pitchBend -= dy (app.cpp:829-836)
                m = self.markers[self.selected]
                m.d_time += dx * self.range_time / width
                m.pitch_bend -= dy * self.range_note / height
                self.invalidate()

    def _hit_test(self, x: float, y: float) -> Optional[int]:
        """Marker within an 8-px box of the warped+bent position
        (app.cpp:927-931)."""
        width = self.viewport.width
        height = self.viewport.lane_height
        time = x * self.range_time / width + self.start_time
        note = (height - y) * self.range_note / height + self.start_note
        d_time = 8 * self.range_time / width
        d_note = 8 * self.range_note / height
        for i, m in enumerate(self.markers):
            if (
                abs(self.knots.sample_to_time(m.sample) - time) < d_time
                and abs(m.note - note + m.pitch_bend) < d_note
            ):
                return i
        return None

    def mouse_button(self, x: float, y: float, pressed: bool, button: int) -> None:
        y -= MENU_BAR_PX
        if not self.loaded:
            return
        width = self.viewport.width
        height = self.viewport.lane_height
        self.markers = sort_markers(self.markers)  # invariant (app.cpp:897-899)
        self._rebuild_knots()

        if button == BUTTON_LEFT and pressed:
            if len(self.wav) < 2:
                return
            if y > height:
                self.follow_mode = False
                self.seek(x * self.range_time / width + self.start_time)
            else:
                hit = self._hit_test(x, y)
                # One history entry per gesture: covers both the add below
                # and the drag that may follow a selection (select-only
                # entries dedupe in push_history/undo).
                self.push_history()
                if hit is None:
                    # Add marker at {sample, note - bend, 0, bend}
                    # (app.cpp:932-945): the *source* note is the clicked
                    # visual note minus the current bend.
                    time = x * self.range_time / width + self.start_time
                    sample = self.knots.time_to_sample(time)
                    note = (height - y) * self.range_note / height + self.start_note
                    bend = self.knots.time_to_pitch_bend(time)
                    self.markers.append(Marker(int(sample), note - bend, 0.0, float(bend)))
                    self.markers = sort_markers(self.markers)
                    self.invalidate()
                    self.selected = next(
                        i for i, m in enumerate(self.markers) if m.sample == sample
                    )
                else:
                    self.selected = hit
        elif button == BUTTON_RIGHT and pressed:
            if len(self.wav) < 2:
                return
            hit = self._hit_test(x, y)
            if hit is not None:
                self.push_history()
                del self.markers[hit]
                self.selected = None
                self.invalidate()

    def toggle_play(self) -> None:
        if not self.loaded:
            return
        self.is_playing = not self.is_playing
        if self.player is not None:
            if self.is_playing:
                self.player.seek(self.cursor_sec)
                self.player._fading = False
                self.player.is_playing = True
            else:
                self.player.is_playing = False

    def seek(self, t: float) -> None:
        """Move the cursor; playback (if live) continues from here — the
        reference brackets this with the audio lock (app.cpp:825-827)."""
        self.cursor_sec = float(np.clip(t, 0.0, self.duration()))
        if self.player is not None:
            self.player.seek(self.cursor_sec)

    def cursor_left(self) -> None:
        """← moves the cursor by 4 px of time (app.cpp:991-1004)."""
        if len(self.wav) < 2:
            return
        self.follow_mode = False
        self.seek(self.cursor_sec - 4 * self.range_time / self.viewport.width)

    def cursor_right(self) -> None:
        if len(self.wav) < 2:
            return
        self.follow_mode = False
        self.seek(self.cursor_sec + 4 * self.range_time / self.viewport.width)

    def tick_follow(self) -> None:
        """Per-frame follow-mode auto-scroll (app.cpp:108-127): keep the
        cursor at 1/5 of the view with exponential catch-up.  Implements the
        intended behavior (the reference's final gate looks inverted)."""
        if not self.loaded:
            return
        if self.cursor_sec > self.start_time + self.range_time and self.is_playing:
            self.follow_mode = True
        if self.follow_mode:
            desired = self.cursor_sec - self.range_time / 5
            if abs(desired - self.start_time) > 4 * 1024.0 / self.sample_rate:
                new_start = self.start_time + (desired - self.start_time) * 0.2
            else:
                new_start = desired
            self.start_time = new_start

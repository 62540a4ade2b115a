"""The port's recorder of spans (``melonix_tpu_torch.utils.tracing``): off,
on, on the PV's and the pitch curve's paths, under ``torch.profiler``, in
threads, and full.  The case marked ``chip`` needs an NVIDIA card and skips
without one (``python -m pytest tests/test_torch_tracing.py -m chip
--noconftest`` on a machine with a card: this file imports no JAX)."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import melonix_tpu_torch as mt
from melonix_tpu_torch.engine import phase_vocoder, pitch, session
from melonix_tpu_torch.utils import tracing

SR = 44100
N = 3 * SR
MARKERS = [(int(0.5 * SR), 57.0, 0.01, 2.0),
           (int(1.5 * SR), 57.0, -0.01, -1.5),
           (int(2.2 * SR), 57.0, 0.0, 1.0)]


@pytest.fixture
def recorder():
    tracing.start()
    yield tracing
    tracing.stop()


@pytest.fixture
def take():
    t = np.arange(N) / SR
    return (0.4 * np.sin(2 * np.pi * 220.0 * t)
            + 0.1 * np.sin(2 * np.pi * 660.0 * t)).astype(np.float32)


def knots():
    return mt.MapKnots.from_markers([mt.Marker(*m) for m in MARKERS], SR, N)


def segment_starts(k, plan):
    """The anchors a plan places at rate-segment starts: the distinct first
    output samples of its segments."""
    t0s = phase_vocoder._segment_table(k, plan.n_out / SR)[0]
    j0 = np.clip(np.ceil(t0s * SR - 1.0 - 1e-9), 0, plan.n_out_pad - 1)
    return len(np.unique(j0))


def by_name(recs):
    out = {}
    for i, r in enumerate(recs):
        out.setdefault(r.name, []).append(i)
    return out


def test_off_a_span_is_the_shared_no_op_and_keeps_nothing(take):
    tracing.start()
    tracing.stop()
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", bytes=3)
    assert a is b
    with a as s:
        s.count(bytes=1)
    phase_vocoder.render_track_pv(torch.from_numpy(take), knots(),
                                  device_out=True)
    assert tracing.records() == []
    assert tracing.dropped() == 0


def test_a_pv_render_is_one_request_with_its_plan_under_it(recorder, take):
    k = knots()
    phase_vocoder.render_track_pv(torch.from_numpy(take), k, device_out=True)
    recs = recorder.records()
    plan = phase_vocoder.build_pv_plan(k, N)
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert roots == [0] and recs[0].name == "render_track_pv"
    assert all(r.root == 0 and r.t1_ns >= r.t0_ns for r in recs)
    names = by_name(recs)
    (p,), (kn,), (an,) = (names["pv.plan"], names["pv.plan.knots"],
                          names["pv.plan.anchors"])
    assert recs[p].parent == 0
    assert recs[kn].parent == p and recs[an].parent == p
    assert recs[p].counts == {"frames": plan.n_frames,
                              "anchors": plan.anc_np[4]}
    assert recs[kn].counts == {"frames": plan.n_frames,
                               "knots": len(k.times), "sorted": 1}
    assert recs[an].counts == {"anchors": plan.anc_np[4],
                               "starts": segment_starts(k, plan)}
    for name in ("pv.normalise", "pv.resample_operands"):
        assert [recs[i].parent for i in names[name]] == [0]
    # the CPU render makes no copy between devices and launches nothing
    assert "h2d" not in names and not any(n.startswith("kernel.")
                                          for n in names)
    inner = recs[p]
    assert recs[0].t0_ns <= inner.t0_ns <= inner.t1_ns <= recs[0].t1_ns


@pytest.mark.parametrize("markers, sorted_", [
    (MARKERS, 1),
    # the first segment runs backwards: times 0, -0.5, 0.1
    ([(N // 3, 57.0, -1.5, -5.0), (N // 2, 60.0, 0.1, 7.0)], 0)],
    ids=["forward", "backward"])
def test_the_knot_span_counts_which_segment_lookup_ran(recorder, markers,
                                                       sorted_):
    k = mt.MapKnots.from_markers([mt.Marker(*m) for m in markers], SR, N)
    plan = phase_vocoder.build_pv_plan(k, N)
    (kn,) = [r for r in recorder.records() if r.name == "pv.plan.knots"]
    assert kn.counts == {"frames": plan.n_frames, "knots": len(k.times),
                         "sorted": sorted_}
    assert k.time_to_sample_float_and_bend(0.5)[2] is bool(sorted_)


# one marker a 0.1 s, each on a whole sample with no time shift: every
# segment after the first starts on an output sample's own time
AUTOTUNE = [(int((0.05 + 0.1 * i) * SR), 57.0, 0.0, 0.3 * (-1) ** i)
            for i in range(28)]


@pytest.mark.parametrize("markers", [MARKERS, AUTOTUNE],
                         ids=["shifted", "whole-sample"])
def test_the_anchor_span_counts_the_anchors_at_segment_starts(recorder,
                                                              markers):
    k = mt.MapKnots.from_markers([mt.Marker(*m) for m in markers], SR, N)
    plan = phase_vocoder.build_pv_plan(k, N)
    (an,) = [r for r in recorder.records() if r.name == "pv.plan.anchors"]
    assert an.counts == {"anchors": plan.anc_np[4],
                         "starts": segment_starts(k, plan)}
    assert an.counts["starts"] >= len(markers)


@pytest.mark.parametrize("chunk", [None, 64])
def test_a_formant_render_times_its_gain_once_a_chunk_and_channel(
        recorder, take, monkeypatch, chunk):
    if chunk is not None:
        monkeypatch.setattr(phase_vocoder, "PV_CHUNK_FRAMES", chunk)
    stereo = np.stack([take, 0.5 * take], axis=1)
    session.render_session(stereo, [mt.Marker(*m) for m in MARKERS], SR,
                           engine="pv", preserve_formants=True, mesh=None,
                           device="cpu")
    plan = phase_vocoder.build_pv_plan(knots(), N)
    ch = min(phase_vocoder.PV_CHUNK_FRAMES, plan.n_frames)
    recs = recorder.records()
    gains = [r for r in recs if r.name == "pv.formant"]
    assert len(gains) == 2 * (-(-plan.n_frames // ch))
    assert all(r.counts == {"frames": ch, "bins": 1025, "ceps": 40}
               for r in gains)
    # a CPU render passes no device: the span has no device time
    recorder.resolve()
    assert all(r.device_ms is None for r in recorder.records()
               if r.name == "pv.formant")


def test_a_render_without_formants_has_no_gain_span(recorder, take):
    stereo = np.stack([take, 0.5 * take], axis=1)
    session.render_session(stereo, [mt.Marker(*m) for m in MARKERS], SR,
                           engine="pv", mesh=None, device="cpu")
    assert "pv.formant" not in by_name(recorder.records())


def test_a_pitch_curve_downloads_and_voices_under_one_request(recorder, take):
    c = pitch.pitch_curve(take, SR, device="cpu")
    recs = recorder.records()
    names = by_name(recs)
    assert [recs[i].name for i in range(len(recs))
            if recs[i].parent is None] == ["pitch_curve"]
    assert "h2d" not in names  # a NumPy take on the CPU is not copied
    assert len(names["d2h"]) == 3
    for i in names["d2h"] + names["pitch.voicing"]:
        assert recs[i].parent == 0 and recs[i].root == 0
    assert all(recs[i].counts["bytes"] == 4 * len(c.note)
               for i in names["d2h"])
    (v,) = names["pitch.voicing"]
    assert recs[v].counts == {"frames": len(c.note)}
    assert recs[v].t0_ns >= max(recs[i].t1_ns for i in names["d2h"])


def test_a_session_records_its_host_work_and_its_download(recorder, take):
    stereo = np.stack([take, 0.5 * take], axis=1)
    out = session.render_session(stereo, [mt.Marker(*m) for m in MARKERS],
                                 SR, engine="pv", mesh=None, device="cpu")
    recs = recorder.records()
    names = by_name(recs)
    assert recs[0].name == "render_session" and recs[0].parent is None
    # a C-contiguous float32 take: no downmix, split or transpose
    host = [recs[i] for i in names["session.host"]]
    assert [h.counts for h in host] == [{"passes": 0, "bytes": 0}]
    assert [recs[i].parent for i in names["render_channels_pv"]] == [0]
    assert len(names["render_channels_pv"]) == 1
    # one download of the whole (n_out, 2) render
    assert [recs[i].counts["bytes"] for i in names["d2h"]] == [out.nbytes]
    assert all(r.root == 0 for r in recs)


def test_a_granular_session_counts_its_downmix_split_and_stack(recorder,
                                                               take):
    stereo = np.stack([take, 0.5 * take], axis=1)
    out = session.render_session(stereo, [mt.Marker(*m) for m in MARKERS],
                                 SR, engine="granular", mesh=None,
                                 device="cpu")
    recs = recorder.records()
    host = [recs[i].counts for i in by_name(recs)["session.host"]]
    # each pass counts the bytes it reads and writes
    assert host == [{"passes": 1, "bytes": stereo.nbytes + take.nbytes},
                    {"passes": 1, "bytes": 2 * stereo.nbytes},
                    {"passes": 1, "bytes": 2 * out.nbytes}]
    assert all(r.root == 0 for r in recs)


def test_outputs_are_bitwise_equal_with_the_recorder_on_and_off(take):
    def run():
        pv = phase_vocoder.render_track_pv(torch.from_numpy(take), knots(),
                                           device_out=True)
        c = pitch.pitch_curve(take, SR, device="cpu")
        return pv, c

    tracing.stop()
    off = run()
    tracing.start()
    try:
        on = run()
    finally:
        tracing.stop()
    assert torch.equal(off[0], on[0])
    for f in ("f0", "voiced", "clarity", "note"):
        np.testing.assert_array_equal(getattr(off[1], f), getattr(on[1], f))


def test_under_the_profiler_each_span_is_a_region_of_its_name(recorder,
                                                               take,
                                                               tmp_path):
    from torch.profiler import ProfilerActivity, profile

    # the profiler's first regions in a process, and the first of each of
    # its sessions, initialise it: they are not the recorder's
    with profile(activities=[ProfilerActivity.CPU]):
        pitch.pitch_curve(take, SR, device="cpu")
    recorder.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        pitch.pitch_curve(take, SR, device="cpu")
        phase_vocoder.render_track_pv(torch.from_numpy(take), knots(),
                                      device_out=True)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"] != "warm"]
    recs = recorder.records()
    assert len(events) == len(recs)
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    for rec, ev in zip(recs, events):
        assert ev["name"] == rec.name
        assert abs(ev["dur"] - 1e-3 * (rec.t1_ns - rec.t0_ns)) < 100.0
    for rec, ev in zip(recs, events):
        if rec.parent is not None:
            up = events[rec.parent]
            assert up["ts"] <= ev["ts"]
            assert ev["ts"] + ev["dur"] <= up["ts"] + up["dur"]


def test_trace_starts_the_recorder_for_its_region(tmp_path, take):
    tracing.stop()
    with tracing.trace(str(tmp_path)):
        assert tracing.enabled()
        pitch.pitch_curve(take, SR, device="cpu")
    assert not tracing.enabled()
    assert "pitch.voicing" in {r.name for r in tracing.records()}
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        doc = json.load(f)
    assert any(e.get("name") == "pitch.voicing" for e in doc["traceEvents"])
    # the file carries the region's records, counts and all
    assert doc["melonix_spans"] == [r._asdict() for r in tracing.records()]
    (voicing,) = [r for r in doc["melonix_spans"]
                  if r["name"] == "pitch.voicing"]
    assert voicing["counts"]["frames"] > 0


def test_a_thread_keeps_its_own_parents(recorder):
    """The worker's inner span opens while the main thread's span is open,
    and the main thread's inner span while the worker's is."""
    ready, go, done = threading.Event(), threading.Event(), threading.Event()

    def worker():
        with tracing.span("tile"):
            ready.set()
            go.wait(10)
            with tracing.span("tile.inner"):
                done.set()
                go.wait(10)

    t = threading.Thread(target=worker)
    t.start()
    assert ready.wait(10)
    with tracing.span("main"):
        go.set()
        assert done.wait(10)
        with tracing.span("main.inner"):
            pass
    t.join(10)
    assert not t.is_alive()
    recs = recorder.records()
    idx = {r.name: i for i, r in enumerate(recs)}
    assert recs[idx["tile.inner"]].parent == idx["tile"]
    assert recs[idx["main.inner"]].parent == idx["main"]
    assert recs[idx["tile"]].parent is None and recs[idx["main"]].parent is None
    assert recs[idx["tile.inner"]].root == idx["tile"]
    assert recs[idx["main.inner"]].root == idx["main"]


def test_a_full_buffer_counts_what_it_drops(recorder, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    for i in range(3):
        with tracing.span("kept", i=i):
            pass
    assert recorder.dropped() == 0
    with tracing.span("outer"):
        with tracing.span("dropped"):
            pass
    with tracing.span("dropped too"):
        pass
    assert [r.name for r in recorder.records()] == ["kept"] * 3 + ["outer"]
    assert recorder.dropped() == 2
    recorder.start()
    assert recorder.dropped() == 0 and recorder.records() == []


class _Stream:
    """A stand-in for a CUDA stream, for a machine without a card."""

    def __init__(self, device):
        self.device = device


class _Event:
    """A stand-in for a timed CUDA event: its time is the host's."""

    def record(self, stream):
        self.ns = time.perf_counter_ns()

    def elapsed_time(self, end):
        return 1e-6 * (end.ns - self.ns)


def test_a_full_buffer_takes_no_events_and_resolve_lets_them_go(
        recorder, monkeypatch):
    made = []

    def events(device):
        made.append((_Event(), _Event()))
        return (_Stream(device), *made[-1])

    monkeypatch.setattr(tracing, "_events", events)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    for _ in range(100):
        with tracing.span("kernel.x", device="cuda"):
            pass
    assert len(made) == 4  # the kept spans' pairs alone
    assert recorder.dropped() == 96
    assert len(tracing._pending) == 4
    recorder.resolve()
    assert tracing._pending == []  # read, and let go
    assert all(r.device_ms is not None and r.device_ms >= 0
               for r in recorder.records())
    # a start() lets go of the events of spans still open in the old buffer
    recorder.start()
    with tracing.span("kernel.open", device="cuda"):
        recorder.start()
    assert len(made) == 5
    assert tracing._pending == [] and recorder.records() == []


def test_count_adds_to_the_counts_a_span_was_given(recorder):
    with tracing.span("x", bytes=4) as s:
        s.count(frames=2)
    (r,) = recorder.records()
    assert r.counts == {"bytes": 4, "frames": 2}
    assert r.device_ms is None  # no device given: no events
    recorder.resolve()
    assert r.device_ms is None


@pytest.mark.chip
def test_on_the_card_the_take_goes_up_pageable_and_a_device_span_times(
        take):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tracing.start()
    try:
        pitch.pitch_curve(take, SR, device="cuda")
        phase_vocoder.render_track_pv(take, knots(), device="cuda")
        tracing.resolve()
    finally:
        tracing.stop()
    recs = tracing.records()
    first = recs[: next(i for i, r in enumerate(recs)
                        if r.name == "render_track_pv")]
    (up,) = [r for r in first if r.name == "h2d"]
    assert up.counts == {"bytes": take.nbytes, "pageable": 1}
    kernels = [r for r in recs if r.name.startswith("kernel.")]
    assert {r.name for r in kernels} >= {"kernel.pitch_ac", "kernel.analysis",
                                         "kernel.synth_ola_phase",
                                         "kernel.resample_pv"}
    # the launch spans are the host's alone; a span given the card times
    # its region on the card's current stream
    assert all(r.device_ms is None for r in kernels)
    tracing.start()
    phase_vocoder.render_track_pv(take, knots(), device="cuda",
                                  preserve_formants=True)
    tracing.stop()
    tracing.resolve()
    (gain,) = [r for r in tracing.records() if r.name == "pv.formant"]
    assert gain.device_ms > 0
    tracing.start()
    x = torch.ones(1 << 24, device="cuda")
    with tracing.span("device", device="cuda"):
        x.cumsum_(0)
    tracing.stop()
    tracing.resolve()
    (r,) = tracing.records()
    assert r.device_ms > 0

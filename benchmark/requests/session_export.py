"""Request kind ``session_export``: a stereo export of an autotune edit.

The take is held on the host as a NumPy (n, channels) float32 array, as a
decoded file is held.  Each request is a fresh seeded autotune correction
(``inputs.snap_markers``: one marker a note, ``d_time`` 0, the bend that
snaps its detune, some notes bent further), rendered as ``autotune`` and
the CLI's ``render --engine pv --formant --stereo`` render it: through
``render_session(wav, markers, sr, engine="pv", ...)``, which returns the
(n_out, channels) array.  The reference (``reference/pv.py``) renders each
channel of the take through the same markers from its own plan; as in
``pv_edit``, the program's own stretched signal of each channel is also
followed through the last stage at the reference's positions, to judge
where the samples land.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import compare, inputs
from benchmark.reference import pv as ref_pv

# The program's last stage, ``_resample_pv_fused(plan, y)``, called once a
# channel: the check catches each channel's stretched signal.
RESAMPLE_STAGE = "_resample_pv_fused"
NOT_FOLLOWED = 1e9  # the gap where that stage cannot be followed


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        import melonix_tpu_torch as mt
        from melonix_tpu_torch.engine import phase_vocoder, session

        self.mt, self.pv, self.session = mt, phase_vocoder, session
        self.seed, self.device = seed, device
        self.sr = int(config["sample_rate"])
        self.channels = int(config["channels"])
        self.render_opts = config["render"]
        self.program_config = mt.Config(**config["program_config"])
        self.form = traffic["markers"]
        take, self.notes, self.cents = inputs.melody(
            self.sr, config["seconds"], seed, device, self.channels)
        self.take = take.cpu().numpy()
        del take
        self.n = int(self.take.shape[0])
        self.audio_s = self.n / self.sr

    def markers(self, i: int) -> list:
        f = self.form
        return inputs.snap_markers(inputs.rng(self.seed, 12, i), self.sr,
                                   self.notes, self.cents, f["jitter_s"],
                                   f["extra_share"], tuple(f["extra"]))

    def request(self, i: int) -> np.ndarray:
        with record_function("program.render_session"):
            return self._render(i)

    def _render(self, i: int) -> np.ndarray:
        ms = [self.mt.Marker(*m) for m in self.markers(i)]
        return self.session.render_session(
            self.take, ms, self.sr, engine="pv", config=self.program_config,
            device=self.device, **self.render_opts)

    def _stretches(self, i: int) -> list | None:
        """Each channel's stretched, normalised signal for request ``i``:
        the inputs of its resample stage (``RESAMPLE_STAGE``), caught on a
        second render of the request after the window."""
        caught = []
        stage = getattr(self.pv, RESAMPLE_STAGE, None)
        if stage is not None:
            def catch(plan, y):
                caught.append(y.clone())
                return stage(plan, y)

            setattr(self.pv, RESAMPLE_STAGE, catch)
            try:
                self._render(i)
            finally:
                setattr(self.pv, RESAMPLE_STAGE, stage)
        if len(caught) != self.channels:
            print(f"[bench] the render called phase_vocoder.{RESAMPLE_STAGE}"
                  f" {len(caught)} times, not once a channel "
                  f"({self.channels}): its resample stage cannot be followed",
                  file=sys.stderr)
            return None
        return caught

    def _channel(self, c: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(self.take[:, c])).to(
            self.device)

    def reference(self, i: int, c: int, quantize=None) -> torch.Tensor:
        """The reference's float64 render of channel ``c`` through request
        ``i``'s markers, on the run's device."""
        cfg = self.program_config
        return ref_pv.render(self._channel(c), self.markers(i), self.sr,
                             size=cfg.stft_size, hop=cfg.stft_hop,
                             formants=self.render_opts["preserve_formants"],
                             quantize=quantize)

    def control_request(self, i: int) -> np.ndarray:
        """The reference in bfloat16, in the program's place."""
        cols = [self.reference(i, c, torch.bfloat16).float().cpu()
                for c in range(self.channels)]
        return torch.stack(cols, dim=1).numpy()

    def check(self, kept) -> list[tuple[str, float]]:
        """For each answer, the worse channel of each number."""
        rows = []
        for i, out in kept:
            out = np.asarray(out)
            ys = self._stretches(i)
            src = None
            if ys is not None:
                src = ref_pv.positions(self.markers(i), self.sr, self.n,
                                       self.device)
            for c in range(self.channels):
                got = torch.from_numpy(np.ascontiguousarray(out[:, c])).to(
                    self.device)
                ref = self.reference(i, c)
                row = compare.audio_gaps(got, ref)
                del ref
                row["resample_gap"] = (
                    NOT_FOLLOWED if ys is None else compare.resample_gap(
                        got, ref_pv.lerp(ys[c].to(torch.float64), src)))
                rows.append(row)
                del got
            del ys, src
        return compare.worst(rows)

"""Request kind ``pv_edit``: the editor's re-render after an edit.

The take stays on the card as the editor holds it.  Each request is a
fresh seeded marker edit in ``bench_markers``' form, rendered by the phase
vocoder through ``render_track_pv(..., device_out=True)`` and waited for.
The reference (``reference/pv.py``) renders the same take through the
same markers from its own plan; and, since the phase vocoder's running
phase is chaotic sample by sample, it also follows the program's own
stretched signal through the last stage, resampling it at the
reference's positions, to judge where the samples land.
"""

from __future__ import annotations

import sys

import torch
from torch.profiler import record_function

from benchmark.harness import compare, inputs
from benchmark.reference import pv as ref_pv

# The program's last stage, ``_resample_pv_fused(plan, y)`` (B4 on a
# card): the check catches its input, the stretched signal, and has the
# reference resample it at the reference's own positions.
RESAMPLE_STAGE = "_resample_pv_fused"
NOT_FOLLOWED = 1e9  # the gap where that stage cannot be followed


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        import melonix_tpu_torch as mt
        from melonix_tpu_torch.engine import phase_vocoder

        self.mt, self.pv = mt, phase_vocoder
        self.seed, self.device = seed, device
        self.sr = int(config["sample_rate"])
        self.render_opts = config["render"]
        self.program_config = mt.Config(**config["program_config"])
        self.form = traffic["markers"]
        self.track = inputs.song(self.sr, config["seconds"], seed, device)
        self.n = int(self.track.shape[0])
        self.audio_s = self.n / self.sr

    def markers(self, i: int) -> list:
        f = self.form
        return inputs.edit_markers(inputs.rng(self.seed, 10, i), self.n,
                                   f["count"], f["jitter"],
                                   tuple(f["d_time"]), tuple(f["bend"]))

    def request(self, i: int) -> torch.Tensor:
        with record_function("program.render_track_pv"):
            return self._render(i)

    def _render(self, i: int) -> torch.Tensor:
        ms = [self.mt.Marker(*m) for m in self.markers(i)]
        knots = self.mt.MapKnots.from_markers(ms, self.sr, self.n)
        out = self.pv.render_track_pv(
            self.track, knots, config=self.program_config,
            device_out=True, **self.render_opts)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def _stretch(self, i: int) -> torch.Tensor | None:
        """The program's stretched, normalised signal for request ``i``:
        the input of its resample stage (``RESAMPLE_STAGE``), caught on a
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
        if len(caught) != 1:
            print(f"[bench] the render called phase_vocoder.{RESAMPLE_STAGE}"
                  f" {len(caught)} times, not once: its resample stage "
                  "cannot be followed", file=sys.stderr)
            return None
        return caught[0]

    def _reference(self, i: int, quantize=None) -> torch.Tensor:
        c = self.program_config
        return ref_pv.render(self.track, self.markers(i), self.sr,
                             size=c.stft_size, hop=c.stft_hop,
                             formants=self.render_opts["preserve_formants"],
                             quantize=quantize)

    def control_request(self, i: int) -> torch.Tensor:
        """The reference in bfloat16, in the program's place."""
        out = self._reference(i, torch.bfloat16).float()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def check(self, kept) -> list[tuple[str, float]]:
        rows = []
        for i, out in kept:
            ref = self._reference(i)
            row = compare.audio_gaps(out, ref)
            del ref
            y = self._stretch(i)
            if y is None:
                row["resample_gap"] = NOT_FOLLOWED
            else:
                src = ref_pv.positions(self.markers(i), self.sr, self.n,
                                       self.device)
                row["resample_gap"] = compare.resample_gap(
                    out, ref_pv.lerp(y.to(torch.float64), src))
                del y, src
            rows.append(row)
        return compare.worst(rows)

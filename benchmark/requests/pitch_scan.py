"""Request kind ``pitch_scan``: the pitch curve of each take opened.

A pool of seeded takes held as NumPy arrays, as ``load_audio`` returns
them, with the rests a sung take has (breaths and silences, so that
frames fall on both sides of the clarity and the energy thresholds); each
request is ``pitch_curve(take, sample_rate, device=...)`` on
the next take of a seeded order, back on the host.  The reference
(``reference/pitch.py``) analyses the same take.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import compare, inputs
from benchmark.reference import pitch as ref_pitch


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        import melonix_tpu_torch as mt
        from melonix_tpu_torch.engine import pitch

        self.pitch = pitch
        self.seed, self.device = seed, device
        self.sr = int(config["sample_rate"])
        self.program_config = mt.Config(**config["program_config"])
        self.opts = config["pitch"]
        pool = int(traffic["pool"])
        self.takes = [inputs.song(self.sr, config["seconds"], seed, device,
                                  take=t, rests=traffic["rests"]
                                  ).cpu().numpy() for t in range(pool)]
        self.order = inputs.rng(seed, 11).permutation(pool)
        self.audio_s = len(self.takes[0]) / self.sr

    def take(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def request(self, i: int):
        with record_function("program.pitch_curve"):
            c = self.pitch.pitch_curve(self.takes[self.take(i)], self.sr,
                                       config=self.program_config,
                                       device=self.device, **self.opts)
        return c.note, c.voiced

    def _reference(self, t: int, quantize=None) -> dict:
        c = self.program_config
        wav = torch.from_numpy(self.takes[t]).to(self.device)
        return ref_pitch.curve(
            wav, self.sr, frame=c.pitch_frame, hop=c.pitch_hop,
            fmin=c.pitch_fmin, fmax=c.pitch_fmax,
            clarity_threshold=self.opts["clarity_threshold"],
            energy_threshold=self.opts["energy_threshold"],
            quantize=quantize)

    def control_request(self, i: int):
        """The reference in bfloat16, in the program's place."""
        r = self._reference(self.take(i), torch.bfloat16)
        return r["note"].astype(np.float32), r["voiced"]

    def check(self, kept) -> list[tuple[str, float]]:
        refs, rows = {}, []
        for i, (note, voiced) in kept:
            t = self.take(i)
            if t not in refs:
                refs[t] = self._reference(t)
            rows.append(compare.pitch_gaps(note, voiced, refs[t]))
        return compare.worst(rows)

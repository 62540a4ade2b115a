"""One fake card for the port's kernel wrappers on the CPU.

:func:`fake_card` runs the wrappers' kernel branch on ``meta`` tensors
(allocations without memory) through the one launch path,
``melonix_tpu_torch.kernels._build.launch``: a ``meta`` tensor counts as on
a card, the library is a :class:`Recorder` and the card's current stream
and device context are stand-ins.  The launch path's own span, error check
and launch count run as on the card, so a test sees which entry would
launch, with which arguments (a tensor by its data pointer, the stream
last), and what was counted, without a card.
"""

import contextlib

import torch

from melonix_tpu_torch.kernels import _build


class Recorder:
    """Stands in for the kernel library: records each entry point's call
    as ``(name, args)`` and returns ``code`` (0, or a CUDA error a test
    sets); ``mlx_error_string``, which the error check reads, is not
    recorded."""

    def __init__(self):
        self.calls = []
        self.code = 0

    def __getattr__(self, name):
        if name == "mlx_error_string":
            return lambda err: b"refused"
        return lambda *args: self.calls.append((name, args)) or self.code


def fake_card(monkeypatch, stream: int = 0) -> Recorder:
    """Put the fake card in place for one test (``monkeypatch`` undoes it,
    every wrapper's launch count included) and return its recorder;
    ``stream`` is the handle the launches pass."""
    rec = Recorder()
    for fn in _build.COUNTED:
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "on_card", lambda t: t.device.type != "cpu")
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return rec

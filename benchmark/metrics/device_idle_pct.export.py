"""device_idle_pct.export: 100 x (1 - the union of the card's busy
intervals / the traced window) in the export cells (torch.profiler's CUDA
activity over the traced window)."""

from benchmark.harness.readout import idle_pct


def read(view):
    return idle_pct(view)

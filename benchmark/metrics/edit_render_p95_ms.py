"""edit_render_p95_ms: the 95th percentile over the traced run's window of
the time from an edit to its render done on the card (host clock, ending
in a synchronise)."""

from benchmark.harness.readout import percentile


def read(view):
    return percentile(view, 95.0)

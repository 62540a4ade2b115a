"""analysis_p95_ms: the 95th percentile over all the window's requests of
the time from a take handed over to its pitch curve back on the host."""

from benchmark.harness.readout import percentile


def read(view):
    return percentile(view, 95.0)

"""pv_knots_ms: host ms a request in the PV plan's knot evaluations
(``MapKnots.time_to_sample_float`` and ``time_to_pitch_bend`` at every
frame: the program's ``pv.plan.knots`` spans)."""

from benchmark.harness.program_spans import per_request


def value(rec, recs):
    return rec.host_ms if rec.name == "pv.plan.knots" else None


def read(view):
    return per_request(view, value)

"""render_glue_ms: host ms a request in ``render_track_pv`` less its host
plan (the program's ``render_track_pv`` spans less the ``pv.plan`` spans
inside them): the chunk arrays and their uploads, the normaliser, B4's
operands and the kernels' launch calls."""

from benchmark.harness.program_spans import per_request


def value(rec, recs):
    if rec.name == "render_track_pv":
        return rec.host_ms
    if (rec.name == "pv.plan" and rec.parent is not None
            and recs[rec.parent].name == "render_track_pv"):
        return -rec.host_ms
    return None


def read(view):
    return per_request(view, value)

"""pitch_tail_ms: host ms a request in ``pitch_curve``'s downloads and its
NumPy voicing (the program's ``d2h`` and ``pitch.voicing`` spans inside
``pitch_curve``); the first download waits for B8 and ``pitch_core``."""

from benchmark.harness.program_spans import per_request


def value(rec, recs):
    if (rec.name in ("d2h", "pitch.voicing") and rec.parent is not None
            and recs[rec.parent].name == "pitch_curve"):
        return rec.host_ms
    return None


def read(view):
    return per_request(view, value)

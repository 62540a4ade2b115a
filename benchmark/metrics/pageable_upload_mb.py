"""pageable_upload_mb: megabytes (10^6 bytes) a request copied to the card
from pageable host memory (the ``bytes`` of the program's ``h2d`` spans
with ``pageable`` 1)."""

from benchmark.harness.program_spans import per_request


def value(rec, recs):
    c = rec.counts
    if rec.name == "h2d" and c and c.get("pageable") == 1:
        return c["bytes"]
    return None


def read(view):
    b = per_request(view, value)  # whole bytes summed: exact
    return None if b is None else 1e-6 * b

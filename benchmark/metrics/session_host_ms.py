"""session_host_ms: host ms a request in the session's own host work (the
program's ``session.host`` spans: the downmix and channel split before the
render, the transpose back to (n_out, channels) after it)."""

from benchmark.harness.program_spans import per_request


def value(rec, recs):
    return rec.host_ms if rec.name == "session.host" else None


def read(view):
    return per_request(view, value)

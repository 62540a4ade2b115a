"""formant_roofline: the formant gain's least time over its device time, in
percent.  The device time is the program's ``pv.formant`` spans' CUDA
events (the gain and its in-place application to the magnitudes, a chunk of
one channel a span); the least time is the yardstick's bound of the work
that each span's counts fix, counted here so that it is the same whatever
implements the gain:

- bytes: the (frames x bins) float32 magnitudes read and written once and
  the frames' rates read once, 4 (2 frames bins + frames);
- operations: for each of the ceps - 1 cepstral coefficients, the
  projection of the log magnitude onto its cosine (a multiply and an add a
  bin) and the envelope's term at the warped and at the plain bin (a
  multiply and an add each), 6 frames bins (ceps - 1).

None without device times (a CPU run, or a program without the span),
never 0."""

from benchmark.harness.program_spans import per_request
from benchmark.harness.yardstick import bound

SPAN = "pv.formant"


def work(frames: int, bins: int, ceps: int) -> tuple[int, int]:
    """(bytes, operations) of the gain over ``frames`` x ``bins``."""
    return 4 * (2 * frames * bins + frames), 6 * frames * bins * (ceps - 1)


def least_ms(rec, recs):
    if rec.name != SPAN or rec.device_ms is None:
        return None
    c = rec.counts
    return bound(*work(c["frames"], c["bins"], c["ceps"]))[0]


def device_ms(rec, recs):
    return rec.device_ms if rec.name == SPAN else None


def read(view):
    least = per_request(view, least_ms)
    took = per_request(view, device_ms)
    if least is None or not took:
        return None
    return 100.0 * least / took

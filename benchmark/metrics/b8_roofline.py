"""b8_roofline: B8's (the pitch autocorrelation) least time over its
time, in percent.  The time is CUDA events around each call of
``kernels.pitch.pitch_ac``; the least time is the larger of the bytes (the
track's framed span read once, the frames and their autocorrelation
written) over the memory rate and two real FFTs of twice the frame a frame
over the float32 peak."""

from benchmark.harness.readout import roofline_pct
from benchmark.harness.spans import Wrap
from benchmark.harness.yardstick import fft_flops

TARGET = "melonix_tpu_torch.kernels.pitch.pitch_ac"


def note(args, out):
    n = int(args["wav"].shape[0])
    frame, hop, f = int(args["frame"]), int(args["hop"]), int(args["n_frames"])
    words = min(n, (f - 1) * hop + frame) + 2 * f * frame
    return {"bytes": 4 * words, "flops": 2 * fft_flops(f, 2 * frame)}


WRAPS = [Wrap(TARGET, device=True, note=note)]


def read(view):
    return roofline_pct(view, TARGET)

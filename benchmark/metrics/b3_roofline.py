"""b3_roofline: B3's (phase scan, synthesis, overlap-add) least time
over its time, in percent.  The time is CUDA events around each call of
``kernels.pv.synth_ola_phase``; the least time is the larger of the bytes
its operands and results need over the memory rate and its inverse FFTs'
operations over the float32 peak, from the call's frames, FFT size and
output samples."""

from benchmark.harness.readout import roofline_pct
from benchmark.harness.spans import Wrap
from benchmark.harness.yardstick import fft_flops

TARGET = "melonix_tpu_torch.kernels.pv.synth_ola_phase"


def note(args, out):
    f = int(args["f_real"])
    size, hop = int(args["size"]), int(args["hop"])
    nb = size // 2 + 1
    # read: two (F, nb) spectra, F advances, the window, three carries in;
    # written: the overlap-add of F frames and three carries out
    words = 2 * f * nb + f + size + 3 * nb + (f - 1) * hop + size + 3 * nb
    return {"bytes": 4 * words, "flops": fft_flops(f, size)}


WRAPS = [Wrap(TARGET, device=True, note=note)]


def read(view):
    return roofline_pct(view, TARGET)

"""pv_plan_ms: host ms a request in the phase vocoder's float64 plan."""

from benchmark.harness.readout import per_request
from benchmark.harness.spans import Wrap

TARGET = "melonix_tpu_torch.engine.phase_vocoder.build_pv_plan"
WRAPS = [Wrap(TARGET)]


def read(view):
    return per_request(view, TARGET)

"""upload_ms: device ms a request in the pitch path's upload of the take
(CUDA events around ``track_on_device`` as ``engine/pitch.py`` calls it)."""

from benchmark.harness.readout import per_request
from benchmark.harness.spans import Wrap

TARGET = "melonix_tpu_torch.engine.pitch.track_on_device"
WRAPS = [Wrap(TARGET, device=True)]


def read(view):
    return per_request(view, TARGET, "device_ms")

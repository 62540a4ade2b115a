"""Process-wide metrics, profiling and logging of the port."""

from .metrics import Counter, RateMeter, Timer, registry, snapshot
from .tracing import annotate, get_logger, trace

__all__ = [
    "Counter",
    "RateMeter",
    "Timer",
    "registry",
    "snapshot",
    "annotate",
    "get_logger",
    "trace",
]

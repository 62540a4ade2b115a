"""Process-wide metrics, profiling and logging of the port."""

from .metrics import Counter, RateMeter, Timer, registry, snapshot
from .tracing import get_logger, trace

__all__ = [
    "Counter",
    "RateMeter",
    "Timer",
    "registry",
    "snapshot",
    "get_logger",
    "trace",
]

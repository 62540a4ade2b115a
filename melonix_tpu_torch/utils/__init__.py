"""Process-wide metrics of the port (counters, rates, timers)."""

from .metrics import Counter, RateMeter, Timer, registry, snapshot

__all__ = ["Counter", "RateMeter", "Timer", "registry", "snapshot"]

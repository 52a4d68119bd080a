"""The controller plane of the port: the descheduler (drift repair — its
strategies nominate misplaced bound pods, one dense what-if matrix scored by
the `whatif_score` kernel rescores them, and gang-whole, hysteresis-gated
moves drain through the rate-limited eviction funnel). Driven in-process
over a clientset (`DeschedulerController(cs).tick_once()`); the process
entry point and the HTTP clientset are not ported."""

from .descheduler import (
    DeschedulerController,
    DuplicateReplicas,
    LowNodeUtilization,
    TaintViolation,
    clears_hysteresis,
)
from .evictor import RateLimitedEvictor, TokenBucket

__all__ = [
    "DeschedulerController",
    "DuplicateReplicas",
    "LowNodeUtilization",
    "RateLimitedEvictor",
    "TaintViolation",
    "TokenBucket",
    "clears_hysteresis",
]

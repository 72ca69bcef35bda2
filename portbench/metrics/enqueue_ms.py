"""Host milliseconds to enqueue one compiled call (``CompiledBatched.
__call__()`` without a sync), the median over the measured window's
calls; across ranks, the slowest."""

import statistics

UNIT = "ms"
ACROSS = max


def read(rec):
    return statistics.median(rec["enqueue_ms"]) if rec["enqueue_ms"] else None

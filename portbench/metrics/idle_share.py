"""Share of the profiled window in which the card runs no device record,
from the union of the records' intervals.  Across ranks, the mean."""

from portbench.timing import busy_us

UNIT = "%"
ACROSS = "mean"


def read(rec):
    p = rec["profile"]
    if p["window"] is None:
        return None
    lo, hi = p["window"]
    return 100.0 * (1.0 - busy_us(p["device"], lo, hi) / (hi - lo))

"""The least time any implementation of the call needs, the recording read
once and the output written once at the card's published 3.35 TB/s, as a
share of the call's device time: the union of the device records over the
profiled window, over its calls.  Across ranks, the mean."""

from portbench.peaks import H100_SXM
from portbench.timing import busy_us

UNIT = "%"
ACROSS = "mean"


def read(rec):
    p = rec["profile"]
    if not p["device"] or p["window"] is None or not p["calls"]:
        return None
    device_s = busy_us(p["device"], *p["window"]) * 1e-6 / p["calls"]
    g = rec["geometry"]
    least_s = (g["bytes_in"] + g["bytes_out"]) / H100_SXM["hbm_bytes_per_s"]
    return 100.0 * least_s / device_s

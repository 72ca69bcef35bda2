"""Device records of one call (kernels, copies and fills), counted under
the profiler between waited spin kernels; the reading two sessions agree
on.  Across ranks, the most."""

UNIT = "kernels"
ACROSS = max


def read(rec):
    got = rec["kernel_count"]
    return float(sum(got.values())) if got else None

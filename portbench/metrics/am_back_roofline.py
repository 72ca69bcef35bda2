"""The AM chain's back at the decimated rate (today kernel K12 twice, the
AGC's reduction and its scan, K15 twice, the gain's and the DC blocker's
prefixes, K16's envelope, K13 twice, the DC blocker's state and its
filter, the volume and the glue between them) against its least time:
every device record from a call's first K12 launch to the call's last
record (am_front_roofline.py's ``split``).

The least time is the larger of
  - the decimated I/Q planes read once and the audio written once (f32)
    at 3.35 TB/s: 2 x 4 x 10,485,760 + 4 x 10,485,760 bytes = 125.8 MB,
    0.0376 ms a call;
  - its f32 operations at 67 TFLOP/s, 18 an output: the envelope the
    gains read (2 multiplies, an add, a root), the factor ``1 - mu |x|``
    (2), the gain's step (a multiply-add, 2), the gain on both planes
    (2), the envelope of the result (4), the DC blocker (a difference and
    a multiply-add, 3) and the volume (1): 0.189 GFLOP, 0.0028 ms.
Across ranks, the mean."""

from portbench.metrics.am_front_roofline import geometry, split
from portbench.peaks import H100_SXM

UNIT = "%"
ACROSS = "mean"
FLOPS_PER_OUTPUT = 18


def read(rec):
    got = split(rec)
    calls = rec["profile"]["calls"]
    if got is None or not got[1] or not calls:
        return None
    _, _, n_out, _ = geometry(rec)
    least = max((2 * 4 * n_out + 4 * n_out) / H100_SXM["hbm_bytes_per_s"],
                FLOPS_PER_OUTPUT * n_out / H100_SXM["f32_flops"])
    return 100.0 * least / (got[1] * 1e-6 / calls)

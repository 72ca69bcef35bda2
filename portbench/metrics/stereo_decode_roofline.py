"""``StereoDecode`` (kernel K14's ``power_kernel`` and ``cascade_kernel``,
and the K15 prefix launch of its pilot lock that runs between them)
against its least time: the larger of the composite read once plus the
L/R planes written once (f32) at 3.35 TB/s and its f32 operations at 67
TFLOP/s, five 65-tap FIRs and 13 operations of pilot arithmetic an
output, as the port's utils/roofline.py counts the stage.  A call's stage
runs from its first ``power_kernel`` to the ``cascade_kernel`` after it
(the kernels do not name their op).  Across ranks, the mean."""

from portbench.peaks import H100_SXM
from portbench.timing import is_kernel

OPEN, CLOSE = "power_kernel", "cascade_kernel"
INSIDE = (OPEN, CLOSE, "prefix_warp_kernel", "prefix_thread_kernel")
UNIT = "%"
ACROSS = "mean"


def read(rec):
    p = rec["profile"]
    lo, hi = p["window"]
    us, inside = 0.0, False
    for n, s, e in p["device"]:
        if s < lo or e > hi:
            continue
        inside = inside or is_kernel(n, OPEN)
        if inside and any(is_kernel(n, k) for k in INSIDE):
            us += e - s
        if is_kernel(n, CLOSE):
            inside = False
    if not us or not p["calls"]:
        return None
    tr = rec["geometry"]["traffic"]
    cfg = rec["geometry"]["config"]
    n_c = tr["blocks"] * tr["block_bytes"] // 2 // cfg["front"]["factor"]
    K = cfg["stereo_decoder"]["taps"]
    least = max(4 * 3 * n_c / H100_SXM["hbm_bytes_per_s"],
                (5 * 2.0 * K + 13) * n_c / H100_SXM["f32_flops"])
    return 100.0 * least / (us * 1e-6 / p["calls"])

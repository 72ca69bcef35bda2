"""The AM chain's full-rate front (today kernel K10's u8 conversion, K8's
quarter-band shift, K3's decimate-by-16 and the filter's halo copies)
against its least time: every device record of a call before the
call's first launch of K12 (``reduce_kernel`` or ``scan_kernel``, the AGC),
which opens the back (:func:`split`).

The least time is the larger of
  - the u8 recording read once and the decimated I/Q planes written once
    (f32) at 3.35 TB/s: 32 x 10,485,760 bytes + 2 x 4 x 10,485,760 bytes
    = 419.4 MB, 0.1252 ms a call;
  - the front's f32 operations at 67 TFLOP/s: the rotation, a complex
    product (6 operations) a complex input sample, and the FIR, 2
    operations (a multiply and an add) a tap, ``taps`` taps on each of
    the two planes an output: 6 x 167,772,160 + 2 x 64 x 2 x 10,485,760
    = 3.69 GFLOP, 0.0551 ms.
Across ranks, the mean."""

from portbench.peaks import H100_SXM
from portbench.timing import is_kernel, is_port_kernel

UNIT = "%"
ACROSS = "mean"
OPEN = ("reduce_kernel", "scan_kernel")                     # K12
BACK = OPEN + ("prefix_warp_kernel", "prefix_thread_kernel",    # K15
               "envelope_kernel", "section_kernel")             # K16, K13


def split(rec):
    """Microseconds of the profiled window's device records in the
    chains' fronts and backs: a back opens at a K12 launch that follows
    a front and runs through every record up to the next of the
    program's kernels that is not one of the back's (``BACK``: K12, K15,
    K16, K13), which opens the next call's front.  ``(front, back)``, or
    None where no back opened."""
    p = rec["profile"]
    lo, hi = p["window"]
    us = {"front": 0.0, "back": 0.0}
    part, opened = "front", False
    for n, s, e in p["device"]:
        if s < lo or e > hi:
            continue
        if is_port_kernel(n, rec["port_kernels"]):
            if part == "front" and any(is_kernel(n, k) for k in OPEN):
                part, opened = "back", True
            elif part == "back" and not any(is_kernel(n, k) for k in BACK):
                part = "front"
        us[part] += e - s
    return (us["front"], us["back"]) if opened else None


def geometry(rec):
    """(u8 bytes, complex input samples, decimated outputs, taps) of a
    call on one rank."""
    tr, cf = rec["geometry"]["traffic"], \
        rec["geometry"]["config"]["channel_filter"]
    n_bytes = tr["blocks"] * tr["block_bytes"]
    n_in = n_bytes // 2
    return n_bytes, n_in, n_in // cf["factor"], cf["taps"]


def read(rec):
    got = split(rec)
    calls = rec["profile"]["calls"]
    if got is None or not got[0] or not calls:
        return None
    n_bytes, n_in, n_out, K = geometry(rec)
    least = max((n_bytes + 2 * 4 * n_out) / H100_SXM["hbm_bytes_per_s"],
                (6.0 * n_in + 2.0 * K * 2 * n_out) / H100_SXM["f32_flops"])
    return 100.0 * least / (got[0] * 1e-6 / calls)

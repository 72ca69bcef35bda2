"""``Channelize`` (kernel K7 + DFT, ``branch_dft_kernel``, or K7's
``branch_filter_kernel`` where C takes another route) against its least
time: the larger of the complex64 capture read once plus the channel
streams written once at 3.35 TB/s and its f32 operations at 67 TFLOP/s,
``2 P + 5 log2 C`` an output and plane (P taps a branch), as the port's
utils/roofline.py counts the stage.  Across ranks, the mean."""

import math

from portbench.peaks import H100_SXM
from portbench.timing import device_us, is_kernel

UNIT = "%"
ACROSS = "mean"


def read(rec):
    p = rec["profile"]
    us = device_us(p, lambda n: is_kernel(n, "branch_dft_kernel")
                   or is_kernel(n, "branch_filter_kernel"))
    if not us or not p["calls"]:
        return None
    tr = rec["geometry"]["traffic"]
    bank = rec["geometry"]["config"]["bank"]
    n = tr["blocks"] * tr["block_len"]
    C, P = bank["channels"], bank["taps_per_branch"]
    least = max(2 * 8 * n / H100_SXM["hbm_bytes_per_s"],
                (2.0 * P + 5.0 * math.log2(C)) * n * 2
                / H100_SXM["f32_flops"])
    return 100.0 * least / (us * 1e-6 / p["calls"])

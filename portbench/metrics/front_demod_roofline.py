"""``U8FrontDemod`` (kernel K1, ``u8_front_demod_kernel``: its halo launch
and its main launch) against its least time: the larger of its u8 input
read once plus its f32 demod output written once at 3.35 TB/s, its f32
operations (30 an output, the demod) at 67 TFLOP/s and its integer
multiply-adds (the taps on I and Q) at 1,979 TOP/s, as the port's
utils/roofline.py counts the stage.  Across ranks, the mean."""

from portbench.peaks import H100_SXM
from portbench.timing import device_us, is_kernel

UNIT = "%"
ACROSS = "mean"


def read(rec):
    p = rec["profile"]
    us = device_us(p, lambda n: is_kernel(n, "u8_front_demod_kernel"))
    if not us or not p["calls"]:
        return None
    tr, fr = rec["geometry"]["traffic"], rec["geometry"]["config"]["front"]
    n_bytes = tr["blocks"] * tr["block_bytes"]
    n_out = n_bytes // 2 // fr["factor"]
    least = max((n_bytes + 4 * n_out) / H100_SXM["hbm_bytes_per_s"],
                30.0 * n_out / H100_SXM["f32_flops"],
                2.0 * fr["taps"] * 2 * n_out / H100_SXM["int8_ops"])
    return 100.0 * least / (us * 1e-6 / p["calls"])

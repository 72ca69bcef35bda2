"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A share of a
roofline is stated against these, with the card's power limit beside it."""

H100_SXM = {
    "name": "NVIDIA H100 SXM data sheet",
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops": 67e12,         # CUDA cores, an FMA counted as 2
    "int8_ops": 1979e12,        # dense int8 tensor cores
}

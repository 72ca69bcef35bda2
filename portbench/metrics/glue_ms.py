"""Device milliseconds a call of the records that are neither the
program's own CUDA kernels (``sdr_tpu_torch/csrc``) nor NCCL's: PyTorch's
copies, fills, stacks and elementwise kernels.  Across ranks, the most."""

from portbench.timing import device_us, is_collective, is_port_kernel

UNIT = "ms"
ACROSS = max


def read(rec):
    p = rec["profile"]
    if not p["calls"]:
        return None
    us = device_us(p, lambda n: not is_collective(n)
                   and not is_port_kernel(n, rec["port_kernels"]))
    return us * 1e-3 / p["calls"]

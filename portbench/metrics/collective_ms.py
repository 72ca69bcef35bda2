"""Device milliseconds a call of NCCL's kernels (the sharded runner's
gathers), on the slowest rank; nothing where no NCCL kernel ran."""

from portbench.timing import device_us, is_collective

UNIT = "ms"
ACROSS = max


def read(rec):
    p = rec["profile"]
    us = device_us(p, is_collective)
    return us * 1e-3 / p["calls"] if us and p["calls"] else None

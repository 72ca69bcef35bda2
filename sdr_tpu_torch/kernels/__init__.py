"""Hand-written CUDA kernels for Hopper (sm_90a), one module each.

Each module holds the kernel's wrapper, its plain PyTorch version and its
``KERNEL`` (build, bindings and launch count).  A wrapper launches the
kernel for CUDA tensors and takes the plain version only for CPU tensors.
"""

from sdr_tpu_torch.kernels import fir, resample, u8_front_demod

KERNELS = (u8_front_demod.KERNEL, resample.KERNEL, fir.KERNEL)

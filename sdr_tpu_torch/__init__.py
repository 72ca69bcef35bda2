"""sdr_tpu_torch: the sdr_tpu receive chains on PyTorch and hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors ``sdr_tpu``'s module names so each counterpart is easy
to find, and depends on nothing of it: it imports ``torch`` and ``numpy``
(``scipy`` for tap design), never ``jax``.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, and raise when no
GPU is present.

Importing the package turns TF32 off for cuDNN and cuBLAS: every f32 path
here is true f32, as the JAX package runs its FIR products at HIGHEST.
"""

from sdr_tpu_torch.utils.device import strict_fp32

strict_fp32()

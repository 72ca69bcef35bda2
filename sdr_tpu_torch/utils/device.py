"""Explicit device resolution and f32 numerics.

The port runs on the card unless the caller names the CPU: there is no
"CUDA if present" default, so a run that meant to use the GPU cannot
carry on silently on the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "strict_fp32", "device_kind"]


def strict_fp32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls.

    TF32 keeps about three decimal digits; PyTorch enables it for cuDNN by
    default.  The JAX package runs its FIR products at HIGHEST precision
    for the same reason (sdr_tpu/utils/device.py)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    no GPU is present (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA GPU is available; pass "
                "device='cpu' to run the plain PyTorch versions on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def device_kind(device="cuda") -> str:
    """The name of ``device``'s hardware: the card's
    (``torch.cuda.get_device_name``), or 'cpu'.  Raises without a GPU
    unless ``device='cpu'``."""
    dev = resolve_device(device)
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)

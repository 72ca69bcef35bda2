"""Device resolution and CLI helpers."""

from sdr_tpu_torch.utils.args import parse_size  # noqa: F401
from sdr_tpu_torch.utils.device import resolve_device, strict_fp32  # noqa: F401

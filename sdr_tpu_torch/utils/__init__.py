"""Device resolution, CLI helpers and profiling."""

from sdr_tpu_torch.utils.args import parse_size  # noqa: F401
from sdr_tpu_torch.utils.device import (device_kind,  # noqa: F401
                                        resolve_device, strict_fp32)
from sdr_tpu_torch.utils.profiling import trace, profile, timed  # noqa: F401

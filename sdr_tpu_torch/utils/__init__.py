"""Device resolution, CLI helpers, profiling and the roofline."""

from sdr_tpu_torch.utils.args import parse_size  # noqa: F401
from sdr_tpu_torch.utils.device import (device_kind,  # noqa: F401
                                        resolve_device, strict_fp32)
from sdr_tpu_torch.utils.profiling import trace, profile, timed  # noqa: F401
from sdr_tpu_torch.utils.roofline import (  # noqa: F401
    chain_roofline,
    stage_costs,
    Ceilings,
    MEASURED_CEILINGS,
)

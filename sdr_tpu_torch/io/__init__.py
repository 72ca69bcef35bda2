"""Recorded-signal sources and sinks, and the waterfall consumer."""

from sdr_tpu_torch.io.files import (follow_iq_file,  # noqa: F401
                                    iq_file_source, wav_sink)
from sdr_tpu_torch.io.plot import Waterfall  # noqa: F401

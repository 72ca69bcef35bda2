"""Recorded-signal sources and sinks, and the waterfall consumer."""

from sdr_tpu_torch.io.files import (IQ_DTYPES, block_sink,  # noqa: F401
                                    follow_iq_file, iq_file_source,
                                    read_iq_file, wav_sink, write_iq_file)
from sdr_tpu_torch.io.plot import Waterfall  # noqa: F401

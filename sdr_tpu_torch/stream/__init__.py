"""Streaming runtime: stateful block operators and pipelines."""

from sdr_tpu_torch.stream.block import StreamOp  # noqa: F401
from sdr_tpu_torch.stream.ops import (FmDemod, Iir, ResampleFirScale,  # noqa: F401
                                      Scale, StereoDecode, U8FrontDemod,
                                      U8FrontEnd)
from sdr_tpu_torch.stream.pipeline import Pipeline  # noqa: F401
from sdr_tpu_torch.stream.rate import rate  # noqa: F401

"""Streaming runtime: stateful block operators and pipelines."""

from sdr_tpu_torch.stream.block import StreamOp  # noqa: F401
from sdr_tpu_torch.stream.ops import (Agc, AmDemod, Channelize,  # noqa: F401
                                      DcBlocker, FftStream, Fir, FmDemod,
                                      FmMod, Iir, IqConvertI16,
                                      IqConvertU8, Map, Mix,
                                      ResampleFirScale, Scale, StereoDecode,
                                      U8FrontDemod, U8FrontEnd)
from sdr_tpu_torch.stream.pipeline import Pipeline  # noqa: F401
from sdr_tpu_torch.stream.rate import rate, Timer  # noqa: F401
from sdr_tpu_torch.stream.sources import (combine, devnull,  # noqa: F401
                                          fm_mod, fork, noise, print_sink,
                                          stream_random, stream_string, tone)

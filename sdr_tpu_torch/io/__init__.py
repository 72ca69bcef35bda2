"""Recorded-signal sources and sinks."""

from sdr_tpu_torch.io.files import iq_file_source, wav_sink  # noqa: F401

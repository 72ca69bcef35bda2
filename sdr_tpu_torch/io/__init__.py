"""Host I/O: file, network and live sources and sinks feeding the
pipelines, serialization, and the plot consumers."""

from sdr_tpu_torch.io.files import (  # noqa: F401
    iq_file_source,
    follow_iq_file,
    read_iq_file,
    write_iq_file,
    block_sink,
    wav_sink,
    IQ_DTYPES,
)
from sdr_tpu_torch.io.net import udp_source, udp_sink  # noqa: F401
from sdr_tpu_torch.io.rtl_tcp import (  # noqa: F401
    RtlTcpParams,
    RtlTcpSource,
    rtl_tcp_source,
    parse_rtl_tcp_url,
)
from sdr_tpu_torch.io.audio import audio_available, audio_sink  # noqa: F401
from sdr_tpu_torch.io.native import (  # noqa: F401
    native_file_source,
    native_udp_source,
    native_available,
    build_native,
)
from sdr_tpu_torch.io.plot import (  # noqa: F401
    plot_line,
    plot_fill,
    Waterfall,
    zero_axis,
    centered_axis,
)
from sdr_tpu_torch.io.serialize import (  # noqa: F401
    to_bytes,
    from_bytes,
    frame_blocks,
    write_framed,
    read_framed,
)

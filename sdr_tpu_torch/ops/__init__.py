"""DSP ops on tensors (counterpart of sdr_tpu/ops): conversion, frequency
shift, the FIR engine, demodulation, scans, FFTs, filter design, the
polyphase channelizer and IIR filters.  The JAX package's matrix-unit
FFTs (``fft_mxu``, ``fft_mxu_planar``) are TPU-only and not ported."""

from sdr_tpu_torch.ops.convert import (  # noqa: F401
    iq_u8_to_cfloat,
    iq_u8_to_planar,
    iq_i16_to_planar,
    iq_i16_to_cfloat,
    cfloat_to_iq_i16,
    scale,
    cplx_map,
)
from sdr_tpu_torch.ops.shift import (  # noqa: F401
    half_band_up,
    quarter_band_up,
    oscillator,
    mix,
)
from sdr_tpu_torch.ops.fir import (  # noqa: F401
    FirSpec,
    fir_filter,
    fir_decimate,
    fir_resample,
    resample_output_count,
    resample_end_offset,
    prepare_phase_table,
)
from sdr_tpu_torch.ops.demod import (fm_demod, fm_demod_planar,  # noqa: F401
                                     am_demod, fm_mod, fast_atan2)
from sdr_tpu_torch.ops.scans import dc_blocker, agc, linear_scan  # noqa: F401
from sdr_tpu_torch.ops.fftops import (  # noqa: F401
    fft,
    rfft,
    frame,
    spectrogram,
    waterfall_image,
)
from sdr_tpu_torch.ops.design import (  # noqa: F401
    sinc,
    hanning,
    hamming,
    blackman,
    windowed_sinc,
    srrc,
    remez,
    frequency_response,
    plot_frequency,
)
from sdr_tpu_torch.ops.channelize import (  # noqa: F401
    polyphase_channelize,
    channelizer_taps,
)
from sdr_tpu_torch.ops.iir import (  # noqa: F401
    linear_recurrence,
    biquad,
    sosfilt,
    deemphasis_taps,
)

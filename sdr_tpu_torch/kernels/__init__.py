"""Hand-written CUDA kernels for Hopper (sm_90a), one module each.

Each module holds the kernel's wrapper, its plain PyTorch version and its
``KERNEL`` (build, bindings and launch count).  A wrapper launches the
kernel for CUDA tensors and takes the plain version only for CPU tensors.
``KERNELS`` lists them as K1 to K16: K1-K5 replace the JAX package's five
Pallas kernels and K6 (the sequential AGC) its ``lax.scan`` recurrence.
K7-K11 take the place of passes that XLA fuses for the JAX package and
the port ran as several eager ones: K7 the channelizer's branch filter
(and K7 + DFT, a second launch of its source, the branch filter and the
DFT across the branches in one pass), K8 the oscillator mix (planar, and
complex64 in its complex form), K9 the waterfall's ``FftStream`` (frame,
window, FFT, ``|X|`` and shift in one pass), K10 the interleaved-IQ
converts and K11 the FM demod (planar and complex).  K12 and K13 take the place of the JAX package's
``associative_scan`` recurrences: K12 the linear AGC's affine scan (a
row's whole map, or the gains from each row's entering gain), K13 one
IIR section (``DcBlocker``, each biquad of ``Iir``).  K14 takes the place
of ``StereoDecode``'s five 65-tap filters and the glue XLA fuses around
them: launch A the pilot power and lock, launch B the cascade.  K15 and
K16 take the place of the last two XLA sites of the block-parallel AM and
stereo paths: K15 the carries' affine prefixes (the JAX package's
``all_gather`` and ``lax.scan`` over the shards' maps, which the port
composed by doubling in eager operators), each composition and its
entering state in one launch, and K16 AM's planar envelope in one pass.
K9 takes
the transform at the power-of-two frame sizes from 64 to 16,384; at any
other size, in ``ops.fftops``, and across the channelizer's branches at a
C the fused launch does not take, cuFFT still does.
"""

from sdr_tpu_torch.kernels import (affine_prefix, agc, agc_linear,
                                   am_envelope, backhalf, channelize,
                                   fft_stream, fir, fm_demod, iir,
                                   iq_convert, mix, resample,
                                   stereo_decode, u8_front, u8_front_demod)

KERNELS = (u8_front_demod.KERNEL, resample.KERNEL, fir.KERNEL,
           u8_front.KERNEL, backhalf.KERNEL, agc.KERNEL, channelize.KERNEL,
           mix.KERNEL, fft_stream.KERNEL, iq_convert.KERNEL,
           fm_demod.KERNEL, agc_linear.KERNEL, iir.KERNEL,
           stereo_decode.KERNEL, affine_prefix.KERNEL, am_envelope.KERNEL)

"""Stream operators (counterpart of sdr_tpu/stream/ops.py).

  ====================  ====================================================
  ``IqConvertU8``       u8 IQ -> complex64, or planar f32 I/Q
  ``IqConvertI16``      i16 IQ -> complex64, or planar f32 I/Q
  ``U8FrontDemod``      u8 IQ -> convert -> decimate -> FM demod (kernel K1)
  ``U8FrontEnd``        u8 IQ -> convert -> decimate, planar I/Q (K4)
  ``Fir``               FIR filter / decimator (K3) / rational resampler
                        (K2), real, planar or complex
  ``FmDemod``           complex or planar I/Q -> FM demod
  ``FmMod``             real -> complex64 FM modulation, phase carried
  ``StereoDecode``      FM composite -> L/R planes (K14)
  ``ResampleFirScale``  rational resample (K2) -> FIR with the gain folded
                        into its taps (K3); ``fused=True``: both in K5
  ``Iir``               cascaded biquads, e.g. de-emphasis (each section
                        on K13)
  ``Mix``               multiply by a local oscillator, phase carried
                        (K8, planar or complex)
  ``Agc``               automatic gain control (linear on K12, or
                        sequential on K6)
  ``AmDemod``           AM envelope
  ``DcBlocker``         DC blocking IIR (K13)
  ``Scale``             y = k * x
  ``Map``               any elementwise function
  ``FftStream``         windowed overlapping FFT frames (the waterfall;
                        K9 at power-of-two sizes 64-16,384)
  ``Channelize``        polyphase DFT filterbank: wideband -> C channels
                        (K7 + DFT in one launch; K7 and cuFFT at other C)
  ====================  ====================================================

The ops with a u8, resampler, filterbank or frame history read it and
their block through two pointers, so none makes a concatenated copy of a
block.  K3 takes
one pointer, so ``Fir``'s filter and decimator split their outputs at
the seam as the JAX package does: the few that read history come from a
small ``cat(hist, x[:seam])``, the rest straight from the block.
``IqConvertU8(planar=True)``, ``U8FrontEnd`` and ``StereoDecode`` add a
plane axis ([2] I/Q, [2] L/R), the planar ``FmDemod`` and ``AmDemod``
consume one (``map_batch_shape``); the ops after them batch over it.
``Channelize`` adds a channel axis the same way.  ``FftStream`` emits
``[..., frames, size]``: its stream axis is -2 (``time_axis_out``, from
``out_tail``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_tpu_torch.kernels import agc_linear, fft_stream
from sdr_tpu_torch.kernels import stereo_decode as stereo_kernel
from sdr_tpu_torch.kernels import iir as iir_kernel
from sdr_tpu_torch.kernels.am_envelope import am_envelope
from sdr_tpu_torch.kernels.backhalf import resample_fir
from sdr_tpu_torch.kernels.fir import fir_strided
from sdr_tpu_torch.kernels.fm_demod import (fm_demod_complex,
                                             fm_demod_planar)
from sdr_tpu_torch.kernels.iq_convert import iq_convert
from sdr_tpu_torch.kernels.mix import mix_complex, mix_planar
from sdr_tpu_torch.kernels.resample import resample
from sdr_tpu_torch.kernels.u8_front import u8_front
from sdr_tpu_torch.kernels.u8_front_demod import u8_front_demod
from sdr_tpu_torch.ops import design, scans
from sdr_tpu_torch.ops.channelize import branch_taps, channelize_rows
from sdr_tpu_torch.ops.demod import am_demod, fm_mod
from sdr_tpu_torch.ops.fir import (FirSpec, _resample_positions,
                                   as_real_batch, fir_decimate)
from sdr_tpu_torch.ops.iir import companion_power
from sdr_tpu_torch.ops.quantized import u8_front_plan
from sdr_tpu_torch.ops.shift import oscillator, oscillator_planar
from sdr_tpu_torch.parallel.halo import (entering_state,
                                         exclusive_affine_prefix,
                                         exclusive_matrix_affine_prefix,
                                         first_row, left_halo,
                                         right_shift_scalar, substitute_first)
from sdr_tpu_torch.stream.block import StreamOp
from sdr_tpu_torch.utils import profiling
from sdr_tpu_torch.utils.device import resolve_device
from sdr_tpu_torch.utils.graphs import keep

__all__ = ["IqConvertU8", "IqConvertI16", "U8FrontDemod", "U8FrontEnd",
           "Fir", "FmDemod", "FmMod", "StereoDecode", "ResampleFirScale",
           "Iir", "Mix", "Agc", "AmDemod", "DcBlocker", "Scale", "Map",
           "FftStream", "Channelize", "resampler_hist_len"]

_F32 = torch.float32


def _tail(hist: torch.Tensor, x: torch.Tensor, h: int) -> torch.Tensor:
    """The last ``h`` samples of ``concat(hist, x)``, as a new tensor."""
    if x.shape[-1] >= h:
        return x[..., x.shape[-1] - h:].clone()
    return torch.cat([hist, x], dim=-1)[..., hist.shape[-1] + x.shape[-1]
                                        - h:].clone()


def resampler_hist_len(spec: FirSpec, offset: int, n_in: int) -> int:
    """History a rational resampler needs: how far the last output of a
    block reads behind the block start (``Fir.hist_len`` of the JAX
    package)."""
    I, D, K = spec.interpolation, spec.decimation, spec.n_taps
    if (n_in * I) % D:
        raise ValueError(f"block {n_in} incompatible with rate {I}/{D}: "
                         "n_in*I must be divisible by D")
    if I == 1:
        return max(0, K - D)
    # output m + I has m's phase and reads D samples further, so the
    # furthest read is among the last I outputs
    n_out = n_in * I // D
    first = max(0, n_out - I)
    i, o = _resample_positions(n_out - first, I, D, offset, first)
    ktaps = -(-(K - o) // I)            # taps actually read per phase
    max_read = int((i + ktaps - 1).max())
    return max(0, max_read - n_in + 1)


class _IqConvert(StreamOp):
    """Interleaved I/Q ``[..., 2n]`` -> complex64 ``[..., n]``, or planar
    f32 ``[..., 2, n]`` with ``planar=True`` (a [2] plane axis the ops
    after it batch over), in one pass (K10; ops/convert.py's conversions
    on the CPU).  Stateless."""

    def __init__(self, planar: bool = False, device="cuda"):
        self.planar = bool(planar)
        self.device = resolve_device(device)

    def out_len(self, n_in):
        if n_in % 2:
            raise ValueError("interleaved IQ needs even block")
        return n_in // 2

    def out_dtype(self, in_dtype):
        return _F32 if self.planar else torch.complex64

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape) + ((2,) if self.planar else ())

    def apply(self, carry, x):
        return carry, iq_convert(x.contiguous(), self.planar)


class IqConvertU8(_IqConvert):
    """RTL-SDR u8 I/Q: ``(v - 128) / 128`` per component.  int8 bytes are
    read as their u8 bit patterns, as the JAX package reads them."""

    def apply(self, carry, x):
        if x.dtype == torch.int8:
            x = x.view(torch.uint8)
        if x.dtype != torch.uint8:
            raise ValueError(f"IqConvertU8 takes uint8 IQ, not {x.dtype}")
        return super().apply(carry, x)


class IqConvertI16(_IqConvert):
    """BladeRF i16 I/Q: ``v / 2048`` per component; other integer types
    are cast to int16 first, as ops/convert.py casts them."""

    def apply(self, carry, x):
        return super().apply(carry, x.to(torch.int16))


class _U8Front(StreamOp):
    """What the two u8 front ends share: the quantized plan, the block
    geometry and the raw-byte history (``2*(K - f)`` bytes, 0x80 at
    warmup: the byte of the stream's zero sample)."""

    def __init__(self, taps, factor: int, precision: str = "s16",
                 device="cuda"):
        self.taps = np.asarray(taps, dtype=np.float32)
        self.factor = int(factor)
        self.n_taps = self.taps.shape[0]
        self.precision = precision
        self.device = resolve_device(device)
        tq, self.scale = u8_front_plan(self.taps, precision)
        self.tq = torch.as_tensor(tq, device=self.device)

    def out_len(self, n_in):
        if n_in % 2:
            raise ValueError("interleaved IQ needs even block")
        n = n_in // 2
        if n % self.factor:
            raise ValueError(
                f"complex block {n} not divisible by factor {self.factor}")
        return n // self.factor

    def out_dtype(self, in_dtype):
        return _F32

    def hist_len(self) -> int:
        return 2 * max(0, self.n_taps - self.factor)

    def _hist(self, batch_shape):
        return torch.full(tuple(batch_shape) + (self.hist_len(),), 0x80,
                          dtype=torch.uint8, device=self.device)


class U8FrontEnd(_U8Front):
    """u8 IQ ``[..., 2n]`` -> convert -> K-tap decimate-by-f in exact
    integer arithmetic -> planar I/Q ``[..., 2, n/f]`` f32, in one kernel
    (K4).  The integer taps are the JAX package's (8-bit for
    ``precision='s8'``, 16-bit for ``'s16'``), so a sample equals its
    sample bit for bit.

    Carry: the trailing ``2*(K - f)`` raw bytes, 0x80 at warmup."""

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape) + (2,)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        return self._hist(batch_shape)

    def apply(self, carry, x):
        y = u8_front(self.tq, self.scale, self.factor, x, carry,
                     self.out_len(x.shape[-1]))
        return _tail(carry, x, self.hist_len()), y

    def shard_carry(self, xb, initial=None, group=None):
        return substitute_first(
            left_halo(xb, self.hist_len(), fill=0x80, group=group), initial,
            group)


class U8FrontDemod(_U8Front):
    """Fused receive front: u8 IQ -> convert -> K-tap decimate-by-f in
    exact integer arithmetic -> polynomial FM demod, in one kernel (K1).

    Carry: (trailing ``2*(K - f)`` raw bytes, 0x80 at warmup; the last
    decimated ``(I, Q)`` sample, zeros at warmup)."""

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        return (self._hist(batch_shape),
                torch.zeros(tuple(batch_shape) + (2,), dtype=_F32,
                            device=self.device))

    def apply(self, carry, x):
        hist, liq = carry
        y, liq_new = u8_front_demod(self.tq, self.scale, self.factor, x,
                                    hist, liq, self.out_len(x.shape[-1]))
        return (_tail(hist, x, self.hist_len()), liq_new), y

    def shard_carry(self, xb, initial=None, group=None):
        # the previous block's last H + 2f bytes hold the window of its
        # last output: K1's single output over them gives that sample
        H, f2 = self.hist_len(), 2 * self.factor
        halo = left_halo(xb, H + f2, fill=0x80, group=group)
        zeros = torch.zeros(xb.shape[:-1] + (2,), dtype=_F32,
                            device=xb.device)
        _, liq = u8_front_demod(self.tq, self.scale, self.factor,
                                halo[..., H:].contiguous(),
                                halo[..., :H].contiguous(), zeros, 1)
        return substitute_first((halo[..., f2:].contiguous(), liq), initial,
                                group)


class Fir(StreamOp):
    """Streaming FIR filter / decimator / rational resampler over real,
    planar (any leading plane axes batch) or complex64 blocks (the filter
    and decimator on K3's complex form, the resampler as a real batch of
    planes, ops/fir.py).

    Overlap-save: the carry holds the last ``hist_len`` input samples,
    zeros at warmup, and each block is filtered as if it followed them.
    The resampler's phase is block-invariant (``n_in * I / D`` outputs a
    block), so the carry is the history alone.

    The resampler reads history and block through K2's two pointers.  K3
    takes one, so the filter and decimator split a block's outputs at the
    seam (``_seam_plan``, the JAX package's): the ``mb`` outputs that read
    history come from ``cat(hist, x[..., :seam_x])``, a few samples, and
    the rest straight from ``x`` at a rebased start.  A complex block's two
    launches write into one output (``y[..., :mb]`` and ``y[..., mb:]``);
    a real block's outputs are joined.  Every output's sum is the one the
    unsplit ``cat(hist, x)`` form computes, bit for bit."""

    def __init__(self, spec: FirSpec, offset: int = 0, device="cuda"):
        self.spec = spec
        self.offset = int(offset)
        self.device = resolve_device(device)
        self._taps = torch.as_tensor(spec.taps, device=self.device)
        self._table = torch.as_tensor(spec.phase_table, device=self.device)

    @classmethod
    def filter(cls, taps, symmetric: bool = False, device="cuda"):
        return cls(FirSpec(taps, symmetric=symmetric), device=device)

    @classmethod
    def decimator(cls, taps, factor: int, symmetric: bool = False,
                  device="cuda"):
        return cls(FirSpec(taps, decimation=factor, symmetric=symmetric),
                   device=device)

    @classmethod
    def resampler(cls, taps, interpolation: int, decimation: int,
                  offset: int = 0, device="cuda"):
        return cls(FirSpec(taps, interpolation, decimation), offset=offset,
                   device=device)

    def out_len(self, n_in):
        I, D = self.spec.interpolation, self.spec.decimation
        if (n_in * I) % D:
            raise ValueError(f"block {n_in} incompatible with rate {I}/{D}: "
                             "n_in*I must be divisible by D")
        return n_in * I // D

    def hist_len(self, n_in: int) -> int:
        self.out_len(n_in)
        if self.spec.interpolation == 1:
            return max(0, self.spec.n_taps - self.spec.decimation)
        return resampler_hist_len(self.spec, self.offset, n_in)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        complex_in = in_dtype is not None and in_dtype.is_complex
        return torch.zeros(
            tuple(batch_shape) + (self.hist_len(n_in),), device=self.device,
            dtype=torch.complex64 if complex_in else _F32)

    def _seam_plan(self, H: int, n_in: int, n_out: int):
        """``(mb, seam_x, main_start)`` of the seam split of a filter or
        decimator, or None where it does not apply (no history, or taps
        longer than the block)."""
        D, K = self.spec.decimation, self.spec.n_taps
        if H == 0:
            return None
        mb = -(-H // D)                  # outputs whose window reads hist
        seam_x = (mb - 1) * D + K - H    # block samples those windows read
        main_start = mb * D - H          # output mb's window start in x
        if not 0 < seam_x <= n_in or mb >= n_out or H > n_in:
            return None
        return mb, seam_x, main_start

    def apply(self, carry, x):
        n_in = x.shape[-1]
        n_out = self.out_len(n_in)
        H = carry.shape[-1]
        I, D = self.spec.interpolation, self.spec.decimation
        if I > 1:
            xr, rebuild = as_real_batch(x)
            y = rebuild(resample(self._table, I, D, xr,
                                 as_real_batch(carry)[0], self.offset,
                                 n_out))
            return _tail(carry, x, H), y
        plan = self._seam_plan(H, n_in, n_out)
        if plan is None:
            y = fir_decimate(self._taps, D, torch.cat([carry, x], dim=-1),
                             n_out)
        elif x.is_complex():
            mb, seam_x, main_start = plan
            y = x.new_empty(x.shape[:-1] + (n_out,))
            fir_decimate(self._taps, D,
                         torch.cat([carry, x[..., :seam_x]], dim=-1), mb,
                         out=y[..., :mb])
            fir_decimate(self._taps, D, x, n_out - mb, main_start,
                         out=y[..., mb:])
        else:
            mb, seam_x, main_start = plan
            yb = fir_decimate(self._taps, D,
                              torch.cat([carry, x[..., :seam_x]], dim=-1),
                              mb)
            ym = fir_decimate(self._taps, D, x, n_out - mb, main_start)
            y = torch.cat([yb, ym], dim=-1)
        return _tail(carry, x, H), y

    def shard_carry(self, xb, initial=None, group=None):
        return substitute_first(
            left_halo(xb, self.hist_len(xb.shape[-1]), group=group), initial,
            group)


class FmDemod(StreamOp):
    """FM demodulation, ``y[n] = angle(x[n] * conj(x[n-1]))``, of complex64
    ``[..., n]`` (``torch.angle``) or, with ``planar=True``, of planar
    I/Q ``[..., 2, n]``, whose plane axis it consumes.  ``atan2`` (planar
    only): 'poly' (the polynomial of ops/demod.py, 5.8e-7 rad) or 'exact'
    (``torch.atan2``).

    Carry: the last sample (complex64, or the ``(I, Q)`` pair), zeros at
    warmup."""

    def __init__(self, planar: bool = False, atan2: str = "exact",
                 device="cuda"):
        if atan2 not in ("poly", "exact"):
            raise ValueError(f"atan2 must be 'poly' or 'exact', got "
                             f"{atan2!r}")
        if atan2 == "poly" and not planar:
            raise ValueError("atan2='poly' is the planar demod's; the "
                             "complex demod is exact")
        self.planar = bool(planar)
        self.atan2 = atan2
        self.device = resolve_device(device)

    def out_dtype(self, in_dtype):
        return _F32

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape)[:-1] if self.planar else tuple(batch_shape)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        # planar: batch_shape ends with the [2] plane axis, the (I, Q)
        # carry's shape
        return torch.zeros(tuple(batch_shape), device=self.device,
                           dtype=_F32 if self.planar else torch.complex64)

    def apply(self, carry, x):
        # K11 on the card (ops/demod.py's plain forms on the CPU)
        if self.planar:
            y, last = fm_demod_planar(x.contiguous(), carry.contiguous(),
                                      atan2=self.atan2)
        else:
            y, last = fm_demod_complex(x.contiguous(), carry.contiguous())
        return last, y

    def shard_carry(self, xb, initial=None, group=None):
        return substitute_first(left_halo(xb, 1, group=group)[..., 0],
                                initial, group)


class FmMod(StreamOp):
    """FM modulator (the transmit side, ops/demod.py:fm_mod): real f32
    blocks -> complex64, the phase carried mod 2*pi (zeros at warmup).
    Like the JAX op it has no block-parallel form: the phase entering a
    block is the whole stream's sum before it."""

    def __init__(self, sensitivity: float, amplitude: float = 1.0,
                 device="cuda"):
        self.sensitivity = float(sensitivity)
        self.amplitude = float(amplitude)
        self.device = resolve_device(device)

    def out_dtype(self, in_dtype):
        return torch.complex64

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        return torch.zeros(tuple(batch_shape), dtype=_F32,
                           device=self.device)

    def apply(self, carry, x):
        y, phase = fm_mod(x, self.sensitivity, carry, self.amplitude)
        return phase, y


class StereoDecode(StreamOp):
    """Broadcast-FM stereo multiplex decoder: the composite ``[..., n]``
    at ``fs`` (160 kS/s in the FM chain) -> L/R planes ``[..., 2, n]``,
    as the JAX package decodes it (see its docstring for the design).

    Open-loop carrier recovery: bandpass the 19 kHz pilot, square it,
    bandpass at 38 kHz, and normalise by a 65-tap moving average of the
    squared pilot (a soft Wiener normalisation that rolls to zero as the
    pilot power falls below ``pilot_floor``); demodulate the difference,
    lowpass it and the mono sum at 15 kHz.  All five FIRs are 65-tap
    centred filters; the outputs lag the composite by 96 samples.  ``L =
    mono + g*diff``, ``R = mono - g*diff``, with ``g = separation_gain``.
    The cascade runs on K14 (``kernels/stereo_decode.py``): launch A the
    pilot power and lock, launch B the filters, reading the history and
    the block through two pointers and writing both planes.

    **Pilot lock** (``pilot_lock=True``): per block, the normalised pilot
    power ``r = mean(bp19(x)^2) / mean(x^2)`` locks (``r > lock_hi``) or
    unlocks (``r < lock_lo``); in between the previous block's state
    holds.  Unlocked, the difference channel is zeroed (L == R).  Each
    block's decision is an affine map on the entering lock (decisive:
    constant, hold: identity), so block-parallel runs compose them with
    the scalar affine prefix and equal the stream.  Without the lock the
    difference channel is always on.

    Carry: (the trailing 192 composite samples, zeros at warmup; the lock
    state, 0 at warmup).  Where the block holds 192 samples or more, the
    carried history is a view of the block (no copy): a caller that
    overwrites its input buffer between blocks passes a copy."""

    H = 192                     # carry: trailing composite samples
    K = 65                      # all internal FIRs (odd -> integer delay)

    def __init__(self, fs: float = 160_000.0, separation_gain: float = 2.0,
                 pilot_floor: float = 1e-4, pilot_lock: bool = True,
                 lock_hi: float = 0.02, lock_lo: float = 0.005,
                 device="cuda"):
        ny = fs / 2
        if ny <= 53_000:
            raise ValueError(f"composite rate {fs:.0f} too low for the "
                             "stereo multiplex (needs > 106 kS/s)")
        K = self.K
        try:
            self.bp19 = design.remez(
                K, [0, 15_300, 18_300, 19_700, 22_700, ny], [0, 1, 0],
                fs=fs)
            self.bp38 = design.remez(
                K, [0, 24_000, 34_000, 42_000, 52_000, ny], [0, 1, 0],
                fs=fs)
            self.lp15 = design.remez(K, [0, 15_000, 19_000, ny], [1, 0],
                                     fs=fs)
        except ImportError:   # scipy unavailable: the JAX package's fallback
            ws, h = design.windowed_sinc, design.hamming
            self.bp19 = ws(K, 21_000 / ny, h) - ws(K, 17_000 / ny, h)
            self.bp38 = ws(K, 46_000 / ny, h) - ws(K, 30_000 / ny, h)
            self.lp15 = ws(K, 15_000 / ny, h)
        self.avg = np.full(K, 1.0 / K, dtype=np.float32)
        self.gain = float(separation_gain)
        self.pilot_floor = float(pilot_floor)
        self.pilot_lock = bool(pilot_lock)
        if not (0.0 <= lock_lo < lock_hi):
            raise ValueError("need 0 <= lock_lo < lock_hi")
        self.lock_hi, self.lock_lo = float(lock_hi), float(lock_lo)
        self.device = resolve_device(device)
        self._taps = torch.as_tensor(
            np.stack([self.bp19, self.bp38, self.avg, self.lp15]),
            dtype=_F32, device=self.device)
        self._bp19 = self._taps[0]

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape) + (2,)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        bs = tuple(batch_shape)
        return (torch.zeros(bs + (self.H,), dtype=_F32, device=self.device),
                torch.zeros(bs, dtype=_F32, device=self.device))

    def apply(self, carry, x):
        hist, lock = carry
        n = x.shape[-1]
        y, new = stereo_kernel.decode(
            self._taps, hist, x, lock if self.pilot_lock else None,
            self.gain, self.pilot_floor, self.lock_hi, self.lock_lo)
        if new is not None:
            lock = new
        # the trailing H samples of [hist | x]: a view of the block
        if n >= self.H:
            new_hist = x[..., n - self.H:]
        else:
            new_hist = torch.cat([hist[..., n:], x], dim=-1)
        return (new_hist, lock), y

    def shard_carry(self, xb, initial=None, group=None):
        h = left_halo(xb, self.H, group=group)
        lock0 = 0.0
        if initial is not None:
            h = substitute_first(h, initial[0], group)
            lock0 = torch.as_tensor(initial[1], dtype=_F32, device=xb.device)
        if not self.pilot_lock:
            zeros = torch.zeros(xb.shape[:-1], dtype=_F32, device=xb.device)
            return (h, zeros if initial is None else zeros + lock0)
        # the exact entering lock state: each row's decision is an affine
        # map on the lock, composed by the scalar affine prefix, and
        # A * lock0 + B in the same K15 launch; r comes from the same
        # extended block apply will see
        _, a, b = stereo_kernel.pilot_lock(self._bp19, h, xb, None,
                                           self.lock_hi, self.lock_lo)
        return (h, entering_state(a, b, lock0, group))


class ResampleFirScale(StreamOp):
    """Back half: rational resample (K2) -> FIR (K3) -> gain, the gain
    folded into the FIR taps.  Block for block the same output as the
    three-op tail ``[Fir.resampler(taps_r, I, D), Fir.filter(taps_f),
    Scale(gain)]`` of the JAX package.

    The audio FIR lags its input by ``Kf - 1`` resampler outputs, so the
    resampler runs ``Kf - 1`` outputs ahead over ``concat(hist, x)`` at
    the rebased phase ``offset_k = off_u mod I`` with a history of
    ``H1 + q`` samples (``off_u = offset + (Kf - 1)*D``, ``q = off_u //
    I``, ``H1`` the resampler's own history).  The phase is
    block-invariant, so the carry is one input slice.

    ``fused=True`` runs both stages in one kernel (K5), the resampled
    intermediate kept in shared memory; the default runs K2 then K3, as
    the JAX package does by default.  The two give the same samples.
    Leading dims batch (the stereo chain's [2] L/R planes)."""

    def __init__(self, taps_r, interpolation: int, decimation: int,
                 taps_f, gain: float = 1.0, offset: int = 0,
                 fused: bool = False, device="cuda"):
        self.spec = FirSpec(taps_r, interpolation, decimation)
        self.taps_f = np.asarray(taps_f, dtype=np.float32)
        self.gain = float(gain)
        self.offset = int(offset)
        self.fused = bool(fused)
        self.device = resolve_device(device)
        self._taps_scaled = (self.gain * self.taps_f).astype(np.float32)
        I, D = self.spec.interpolation, self.spec.decimation
        off_u = self.offset + (self.taps_f.shape[0] - 1) * D
        self._offset_k = off_u % I
        self._q = off_u // I
        self._table = torch.as_tensor(self.spec.phase_table,
                                      device=self.device)
        self._taps = torch.as_tensor(self._taps_scaled, device=self.device)

    def out_len(self, n_in):
        I, D = self.spec.interpolation, self.spec.decimation
        if (n_in * I) % D:
            raise ValueError(f"block {n_in} incompatible with rate {I}/{D}")
        return n_in * I // D

    def hist_len(self, n_in: int) -> int:
        return resampler_hist_len(self.spec, self.offset, n_in) + self._q

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        return torch.zeros(tuple(batch_shape) + (self.hist_len(n_in),),
                           dtype=torch.float32, device=self.device)

    def apply(self, carry, x):
        n_out = self.out_len(x.shape[-1])
        I, D = self.spec.interpolation, self.spec.decimation
        if self.fused:
            y = resample_fir(self._table, I, D, self._taps, x, carry,
                             self._offset_k, n_out)
        else:
            yr = resample(self._table, I, D, x, carry, self._offset_k,
                          n_out + self.taps_f.shape[0] - 1)
            y = fir_strided(self._taps, yr, n_out)
        return _tail(carry, x, carry.shape[-1]), y

    def shard_carry(self, xb, initial=None, group=None):
        return substitute_first(
            left_halo(xb, self.hist_len(xb.shape[-1]), group=group), initial,
            group)


class Iir(StreamOp):
    """Streaming cascaded-biquad IIR (ops/iir.py) with exact cross-block
    state: each section carries its last two inputs and outputs, and runs
    as one launch of K13 (kernels/iir.py).

    Block-parallel runs: each section is an order-2 linear recurrence, so
    a row reduces to one affine map on the state ``(y[-1], y[-2])``,
    ``s -> C^n s + v`` (``C^n`` from float64, ``v`` the row's final state
    from zero), and the matrix affine prefix over the rows gives the state
    entering each row.  Section ``s+1``'s input is section ``s``'s output,
    known once its entering state is.  That state is rounded otherwise
    than the streamed recurrence's, so the two runs agree to f32 rounding,
    not bitwise.

    Carry: (last two inputs, last two outputs), each ``[..., S, 2]`` in
    time order, zeros at warmup."""

    def __init__(self, sos, device="cuda"):
        sos = np.asarray(sos, dtype=np.float32)
        if sos.ndim == 1:
            sos = sos[None, :]
        if sos.shape[-1] != 6:
            raise ValueError("sos must be [S, 6]")
        self.sos = sos / sos[:, 3:4]  # normalise a0
        self.device = resolve_device(device)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        shape = tuple(batch_shape) + (self.sos.shape[0], 2)
        return (torch.zeros(shape, dtype=_F32, device=self.device),
                torch.zeros(shape, dtype=_F32, device=self.device))

    def _section(self, s):
        """(feed-forward taps as floats, feedback coefficients)."""
        b, a = self.sos[s, :3], self.sos[s, 3:]
        return ([float(v) for v in b],
                np.array([-a[1], -a[2]], dtype=np.float32))

    def apply(self, carry, x):
        xin, yout = carry
        x = x.to(_F32).contiguous()
        new_xin, new_yout = [], []
        for s in range(self.sos.shape[0]):
            b, coeffs = self._section(s)
            xs = xin[..., s, :].contiguous()
            # the state is (y[-1], y[-2]); the carry stores time order
            y, state = iir_kernel.iir_section(x, b, coeffs, xs,
                                              yout[..., s, :].flip(-1))
            new_xin.append(torch.cat([xs, x[..., -2:]], dim=-1)[..., -2:])
            new_yout.append(state.flip(-1))
            x = y
        return (torch.stack(new_xin, dim=-2),
                torch.stack(new_yout, dim=-2)), x

    def shard_carry(self, xb, initial=None, group=None):
        x = xb.to(_F32).contiguous()
        n = x.shape[-1]
        zero = x.new_zeros(x.shape[:-1] + (2,))
        xin_list, yout_list = [], []
        for s in range(self.sos.shape[0]):
            b, coeffs = self._section(s)
            xin = left_halo(x, 2, group=group)
            if initial is not None:
                xin = substitute_first(xin, initial[0][..., s, :], group)
            xin = xin.contiguous()
            # each row's final state from a zero state
            _, v = iir_kernel.iir_section(x, b, coeffs, xin, zero,
                                          store=False)
            # C^n is the same on every row: K15 reads it in place
            Mn = companion_power(tuple(float(c) for c in coeffs), n,
                                 x.device).expand(v.shape[:-1] + (2, 2))
            if initial is None:
                _, enter = exclusive_matrix_affine_prefix(Mn, v, group)
            else:
                s0 = torch.as_tensor(initial[1][..., s, :], dtype=_F32,
                                     device=x.device).flip(-1)
                enter = entering_state(Mn, v, s0, group)
            xin_list.append(xin)
            yout_list.append(enter.flip(-1))
            if s + 1 < self.sos.shape[0]:
                x, _ = iir_kernel.iir_section(x, b, coeffs, xin,
                                              enter.contiguous())
        return (torch.stack(xin_list, dim=-2),
                torch.stack(yout_list, dim=-2))


class Scale(StreamOp):
    """y = k * x (stateless)."""

    def __init__(self, factor: float, device="cuda"):
        self.factor = float(np.float32(factor))
        self.device = resolve_device(device)

    def apply(self, carry, x):
        return carry, x * self.factor


def _rot(ar, ai, br, bi):
    """``(ar + j*ai) * (br + j*bi)`` as planar pairs."""
    return ar * br - ai * bi, ar * bi + ai * br


class Mix(StreamOp):
    """Multiply by the local oscillator ``exp(2*pi*j*freq*n)`` (``freq`` in
    cycles/sample), phase continuous across blocks: complex64 blocks, or
    planar I/Q ``[..., 2, n]`` with ``planar=True`` (the oscillator, the
    carry and the rotation all (cos, sin) pairs).

    Each block multiplies by the oscillator's table and the carried unit
    phasor in one pass on K8 (``kernels/mix.py``: planar, or its complex
    form), then advances the phasor by the block's whole turn and
    renormalises it, so f32 rounding cannot drift its magnitude.  The
    table is made on the host in float64 once per block length and kept
    on the device.  Block-parallel runs give the stream's block b (counted
    across the ranks of a group) the closed-form phasor
    ``exp(2*pi*j*freq*n*b)``, reduced mod 1 in float64 before the f32
    cast.

    Carry: the unit phasor (complex64, or its (re, im) pair), 1 at
    warmup."""

    _TABLES_KEPT = 4

    def __init__(self, freq: float, planar: bool = False, device="cuda"):
        self.freq = float(freq)
        self.planar = bool(planar)
        self.device = resolve_device(device)
        self._tables = {}   # (kind, n[, rows]) -> a table on the device

    def out_dtype(self, in_dtype):
        return _F32 if self.planar else torch.complex64

    def _cached(self, key, make) -> torch.Tensor:
        """The table ``make()`` made once for ``key`` and kept on the
        device (a few are kept), so a call copies nothing from the host."""
        t = self._tables.get(key)
        if t is None:
            t = torch.as_tensor(make(), device=self.device)
            if len(self._tables) >= self._TABLES_KEPT:
                self._tables.pop(next(iter(self._tables)))
            self._tables[key] = t
        return keep(t)

    def _table(self, n: int) -> torch.Tensor:
        make = oscillator_planar if self.planar else oscillator
        return self._cached(("lo", n),
                            lambda: make(n, self.freq, device="cpu"))

    def _turn(self, n: int, rows: int = 1, start: int = 0) -> np.ndarray:
        """float64 angles of ``n * r`` samples for r in [start, start +
        rows), reduced mod 1 turn before the cast."""
        return 2.0 * np.pi * np.mod(
            np.float64(self.freq) * np.float64(n)
            * np.arange(start, start + rows, dtype=np.float64), 1.0)

    def _row_phasors(self, n: int, rows: int, start: int = 0) -> torch.Tensor:
        """f32 ``[rows, 2]``: (cos, sin) of the phase entering each row of
        a block-parallel batch whose row 0 is the stream's block
        ``start``."""
        def make():
            ang = self._turn(n, rows, start)
            return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(
                np.float32)
        return self._cached(("rows", n, rows, start), make)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        if self.planar:
            # batch_shape ends with the [2] plane axis: the phasor pair
            z = torch.zeros(tuple(batch_shape), dtype=_F32,
                            device=self.device)
            z[..., 0] = 1.0
            return z
        return torch.ones(tuple(batch_shape), dtype=torch.complex64,
                          device=self.device)

    def apply(self, carry, x):
        n = x.shape[-1]
        lo = self._table(n)
        ang = self._turn(n, 2)[1]                # the block's whole turn
        if self.planar:
            y = mix_planar(lo, carry.contiguous(), x.contiguous())
            nr, ni = _rot(carry[..., 0], carry[..., 1],
                          float(np.float32(np.cos(ang))),
                          float(np.float32(np.sin(ang))))
            norm = torch.rsqrt(nr * nr + ni * ni)
            return torch.stack([nr * norm, ni * norm], dim=-1), y
        y = mix_complex(lo, carry.contiguous(), x.contiguous())
        new = carry * complex(np.complex64(np.exp(1j * ang)))
        return new / new.abs(), y

    def shard_carry(self, xb, initial=None, group=None):
        # closed form, no collective: the phasors of this rank's rows of
        # the stream, [rank * B, rank * B + B)
        B = xb.shape[0]
        tab = self._row_phasors(xb.shape[-1], B, first_row(B, group))
        lead = xb.shape[:-2] if self.planar else xb.shape[:-1]
        tab = tab.view((B,) + (1,) * (len(lead) - 1) + (2,))
        pr, pi = tab[..., 0], tab[..., 1]
        if initial is not None:
            init = torch.as_tensor(initial, device=xb.device)
            if self.planar:
                pr, pi = _rot(pr, pi, init[..., 0], init[..., 1])
            else:
                pr, pi = _rot(pr, pi, init.real, init.imag)
        pr, pi = pr.expand(lead), pi.expand(lead)
        if self.planar:
            return torch.stack([pr, pi], dim=-1)
        return torch.complex(pr.contiguous(), pi.contiguous())


class AmDemod(StreamOp):
    """AM envelope detector ``|x|`` (stateless): complex64 blocks, or
    planar I/Q ``[..., 2, n]`` with ``planar=True`` (``sqrt(re^2 +
    im^2)``, consuming the plane axis)."""

    def __init__(self, planar: bool = False, device="cuda"):
        self.planar = bool(planar)
        self.device = resolve_device(device)

    def out_dtype(self, in_dtype):
        return _F32

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape)[:-1] if self.planar else tuple(batch_shape)

    def apply(self, carry, x):
        if self.planar:
            return carry, am_envelope(x.contiguous())
        return carry, am_demod(x)


class Agc(StreamOp):
    """Automatic gain control with the gain carried (ops/scans.py):
    complex64 blocks, or planar I/Q ``[..., 2, n]`` with ``planar=True``
    (the gains from the all-real envelope, both planes scaled by them).

    ``method='linear'`` (the default) is exact block-parallel: each row
    reduces to one affine map on its entering gain (``agc_affine`` of
    kernels/agc_linear.py, K12), composed over the rows by
    ``exclusive_affine_prefix``; the gains themselves are K12's scan.

    ``method='scan'``: the literal sequential recurrence (kernel K6 on the
    card), the oracle and the form for ``mu*|x| > 1``; complex or real
    blocks, not planar.  It has no exact block-parallel form: runners
    refuse it unless ``approx_time_sharding=R`` opts into R sweeps, each
    running every row's scan from its entering gain and handing each
    row's final gain to the next row.  The recurrence forgets its entering
    gain exponentially (by a factor of about ``1 - mu*|x|`` a sample), so
    after one sweep a row's entering gain is off by the decay over a whole
    block: far below the chains' bounds for blocks much longer than the
    AGC's time constant.

    Traced (utils/profiling.py), the block-parallel carry's stage splits
    into the inner stages ``affine`` (K12's reduction) and ``prefix``
    (K15), and ``apply`` into ``premise`` (the linear form's counter
    ``agc.premise_breaks``: :meth:`premise_breaks`) and ``gains`` (K12's
    scan).

    Carry: the gain entering the next block (one per stream: the planar
    form drops the plane axis), ``initial`` at warmup."""

    def __init__(self, mu: float, reference: float, initial: float = 1.0,
                 method: str = "linear", approx_time_sharding=None,
                 planar: bool = False, device="cuda"):
        if method not in ("linear", "scan"):
            raise ValueError(f"unknown agc method {method!r}")
        if planar and method != "linear":
            raise ValueError("Agc(planar=True) supports only the linear "
                             "method (the all-real gain scan)")
        if approx_time_sharding is not None and approx_time_sharding < 1:
            raise ValueError("approx_time_sharding must be >= 1")
        self.mu, self.reference = float(mu), float(reference)
        self.initial = float(initial)
        self.method = method
        self.planar = bool(planar)
        self.approx_time_sharding = approx_time_sharding
        self.time_shardable = (method == "linear"
                               or approx_time_sharding is not None)
        self.device = resolve_device(device)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        bs = tuple(batch_shape)[:-1] if self.planar else tuple(batch_shape)
        return torch.full(bs, self.initial, dtype=_F32, device=self.device)

    def premise_breaks(self, x) -> torch.Tensor:
        """The samples of ``x`` at which the linear form's premise breaks,
        ``mu*|x| >= 1`` (the recurrence's factor ``1 - mu*|x|`` not above
        0: the gain can turn negative, and ``|x*g|`` is no longer
        ``|x|*g``), from the envelope the gains read: a 0-dim tensor."""
        m = (torch.hypot(x[..., 0, :], x[..., 1, :]) if self.planar
             else x.abs())
        return torch.count_nonzero(m.mul_(float(np.float32(self.mu))) >= 1)

    def apply(self, carry, x):
        if self.method == "linear":
            with profiling.inner("premise"):
                profiling.count("agc.premise_breaks",
                                lambda: self.premise_breaks(x))
        with profiling.inner("gains"):
            if self.planar:
                y, final = agc_linear.agc_apply(x.contiguous(), self.mu,
                                                self.reference,
                                                carry.contiguous())
                return final, y
            y, final = scans.agc(x, self.mu, self.reference, carry,
                                 method=self.method)
            return final, y

    def shard_carry(self, xb, initial=None, group=None):
        if self.method == "linear":
            with profiling.inner("affine"):
                if self.planar:
                    A, B = agc_linear.agc_affine(xb.contiguous(), self.mu,
                                                 self.reference, planar=True)
                else:
                    A, B = scans.agc_affine(xb, self.mu, self.reference)
            with profiling.inner("prefix"):
                g0 = self.initial if initial is None else torch.as_tensor(
                    initial, dtype=_F32, device=xb.device)
                # the prefixes and Ap * g0 + Bp in one K15 launch
                return entering_state(A, B, g0, group)
        if self.approx_time_sharding is None:
            raise NotImplementedError(
                "Agc(method='scan') cannot be time-sharded exactly; use "
                "the default method='linear' (exact under the "
                "positive-gain premise), approx_time_sharding=R for the "
                "documented sweep approximation, or shard channels.")
        g0 = torch.full(xb.shape[1:-1], self.initial, dtype=_F32,
                        device=xb.device) if initial is None else \
            torch.as_tensor(initial, dtype=_F32, device=xb.device)
        enter = g0.expand(xb.shape[:-1]).contiguous()
        for _ in range(self.approx_time_sharding):
            _, final = scans.agc(xb, self.mu, self.reference, enter,
                                 method="scan", store=False)
            enter = right_shift_scalar(final, group)
            if first_row(xb.shape[0], group) == 0:  # the stream's first row
                enter[0] = g0
        return enter


@functools.lru_cache(maxsize=64)
def _alpha_power(alpha: float, n: int, device: torch.device):
    """``f32(alpha) ** n`` (float64, then rounded to f32) as a 0-dim
    tensor on ``device``, made once (and held by a graph being captured,
    through ``keep``)."""
    return torch.full((), float(np.float32(alpha)) ** n, dtype=_F32,
                      device=device)


class DcBlocker(StreamOp):
    """DC blocking filter ``y[n] = x[n] - x[n-1] + alpha * y[n-1]``
    (ops/scans.py; K13 on the card).  Block-parallel runs are exact up to
    f32 rounding:
    each row reduces to ``y -> alpha^n * y + B`` (``B`` the row's last
    output from a zero state), composed over the rows by
    ``exclusive_affine_prefix``.  Traced, the carry's stage splits into
    the inner stages ``halo`` (the sample before each row), ``state`` (K13,
    each row's last output from rest, no outputs stored) and ``prefix``
    (K15); the ``apply`` stage is K13's launch and its carries.

    Carry: ``(last_sample, last_output)``, two distinct tensors, zeros at
    warmup."""

    def __init__(self, alpha: float = 0.997, device="cuda"):
        self.alpha = float(alpha)
        self.device = resolve_device(device)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        return (torch.zeros(tuple(batch_shape), dtype=_F32,
                            device=self.device),
                torch.zeros(tuple(batch_shape), dtype=_F32,
                            device=self.device))

    def apply(self, carry, x):
        y, new = scans.dc_blocker(x, carry[0], carry[1], self.alpha)
        return new, y

    def shard_carry(self, xb, initial=None, group=None):
        with profiling.inner("halo"):
            last = left_halo(xb, 1, group=group)[..., 0]
            if initial is not None:
                last = substitute_first(last, initial[0], group)
        with profiling.inner("state"):
            _, (_, b) = scans.dc_blocker(xb, last, 0.0, self.alpha,
                                         store=False)
        with profiling.inner("prefix"):
            # alpha^n is the same on every row: K15 reads it in place
            a = keep(_alpha_power(self.alpha, xb.shape[-1],
                                  b.device)).expand_as(b)
            if initial is None:
                return last, exclusive_affine_prefix(a, b, group)[1]
            return last, entering_state(
                a, b, torch.as_tensor(initial[1], dtype=_F32,
                                      device=xb.device), group)


class Map(StreamOp):
    """Stateless elementwise map ``y = fn(x)``; ``dtype`` is the output's
    when ``fn`` changes it."""

    def __init__(self, fn, dtype=None, device="cuda"):
        self.fn = fn
        self.dtype = dtype
        self.device = resolve_device(device)

    def out_dtype(self, in_dtype):
        return self.dtype if self.dtype is not None else in_dtype

    def apply(self, carry, x):
        return carry, self.fn(x)


class FftStream(StreamOp):
    """Windowed overlapping FFT frames: ``[..., n]`` -> ``[..., n/hop,
    size]``, every frame of a block in one call (the frame axis is the
    stream: ``time_axis_out = -2``).

    ``window`` defaults to Hann; ``shift`` centres DC; ``magnitude``
    emits ``|X|`` (f32), else the complex64 spectrum.  ``planar=True``
    takes planar I/Q ``[..., 2, n]`` f32 (consuming the plane axis); it
    requires ``magnitude=True``.

    Route, by shape before any launch (``kernels.fft_stream.
    kernel_route``): on the card a power-of-two ``size`` from 64 to
    16,384 runs K9 (``kernels/fft_stream.py``), which frames the carry and
    the block through two pointers, windows, transforms and writes ``|X|``
    or ``X`` with the shift in one pass, the planes never made complex64;
    any other size takes the plain version on cuFFT (the planes made
    complex64, framed, ``torch.fft``, ``abs``, ``fftshift``), as do CPU
    tensors on pocketfft.  K9's own FFT agrees with cuFFT within 1e-5 of
    each frame's peak, and its planar and complex forms are bitwise equal
    (the JAX package's planar form writes ``sqrt(re^2 + im^2)``, within an
    ulp of its complex form's ``|X|``).  A failed build or launch raises.

    Carry: the trailing ``size - hop`` input samples, zeros at warmup."""

    def __init__(self, size: int, hop: int | None = None, window=None,
                 shift: bool = True, magnitude: bool = True,
                 planar: bool = False, device="cuda"):
        self.size = int(size)
        self.hop = int(hop) if hop is not None else self.size
        if self.hop > self.size:
            raise ValueError("hop must be <= size")
        if planar and not magnitude:
            raise ValueError("planar FftStream requires magnitude=True")
        self.window = (np.asarray(window, dtype=np.float32)
                       if window is not None else design.hanning(self.size))
        self.shift = bool(shift)
        self.magnitude = bool(magnitude)
        self.planar = bool(planar)
        self.device = resolve_device(device)
        self._window = torch.as_tensor(self.window, device=self.device)

    def out_len(self, n_in):
        if n_in % self.hop:
            raise ValueError("block must be divisible by hop")
        return n_in // self.hop

    def out_tail(self):
        return (self.size,)

    def out_dtype(self, in_dtype):
        return _F32 if self.magnitude else torch.complex64

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape)[:-1] if self.planar else tuple(batch_shape)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        # planar: batch_shape ends with the [2] plane axis
        return torch.zeros(tuple(batch_shape) + (self.size - self.hop,),
                           dtype=in_dtype if in_dtype is not None else _F32,
                           device=self.device)

    def apply(self, carry, x):
        H, n = self.size - self.hop, x.shape[-1]
        if not H:
            new = carry
        elif n >= H:
            new = x[..., n - H:].clone()
        else:                           # a block shorter than the carry
            new = torch.cat([carry[..., n:], x], dim=-1)
        args = (carry.contiguous(), x.contiguous(), self._window, self.hop,
                self.magnitude, self.shift)
        if x.device.type == "cuda" and \
                fft_stream.kernel_route(self.size) == "k9":
            return new, fft_stream.fft_stream(*args)
        return new, fft_stream.fft_stream_reference(*args)

    def shard_carry(self, xb, initial=None, group=None):
        return substitute_first(
            left_halo(xb, self.size - self.hop, group=group), initial, group)


class Channelize(StreamOp):
    """Streaming polyphase DFT filterbank (ops/channelize.py): wideband
    complex ``[..., n]`` -> channel streams ``[..., C, n/C]`` complex64,
    the channel axis a batch axis for the ops after it
    (``map_batch_shape``), each channel's samples the stream.

    Carry: the trailing ``(P - 1) * C`` wideband samples (P taps a
    branch), zeros at warmup, so every block emits ``n/C`` samples a
    channel with the branch filters' history.  The filterbank (K7 + DFT
    in one launch where C is a power of two from 64 to 1,024, else K7
    and cuFFT) reads the carry and the block through two pointers; the
    new carry is a copy of the last ``(P - 1) * C`` samples only."""

    def __init__(self, taps, n_channels: int, device="cuda"):
        self.n_channels = int(n_channels)
        self.taps = np.asarray(taps, dtype=np.float32)
        self.taps_per_branch = -(-self.taps.shape[0] // self.n_channels)
        self.device = resolve_device(device)
        self._hb = branch_taps(self.taps, self.n_channels, self.device)

    def hist_len(self) -> int:
        return (self.taps_per_branch - 1) * self.n_channels

    def out_len(self, n_in):
        if n_in % self.n_channels:
            raise ValueError("block must be divisible by channel count")
        return n_in // self.n_channels

    def out_dtype(self, in_dtype):
        return torch.complex64

    def map_batch_shape(self, batch_shape):
        return tuple(batch_shape) + (self.n_channels,)

    def init_carry(self, n_in, batch_shape=(), in_dtype=None):
        return torch.zeros(tuple(batch_shape) + (self.hist_len(),),
                           dtype=in_dtype if in_dtype is not None
                           else torch.complex64, device=self.device)

    def apply(self, carry, x):
        H = self.hist_len()
        y = channelize_rows(self._hb, carry.contiguous(), x.contiguous(),
                            x.shape[-1] // self.n_channels)
        return (_tail(carry, x, H) if H else carry), y

    def shard_carry(self, xb, initial=None, group=None):
        return substitute_first(left_halo(xb, self.hist_len(), group=group),
                                initial, group)
